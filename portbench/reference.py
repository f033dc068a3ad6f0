"""The plain reference that decides ``correct``: plain PyTorch on the host.

It imports nothing of the partitioner and takes nothing it made.  It reads
the benchmark's own edge list of each graph (``graphgen.EdgeList``) and
judges what the partitioner returned for it, answer by answer, against
the guarantees the configuration states:

* ``bad_answers``: an answer missing, of the wrong shape, with a label
  outside ``[0, k)``, a best trial out of range, or parts that are not the
  best trial's parts.
* ``report_gap``: reported numbers that disagree with the partition they
  describe: the cut, each trial's cut, the balance flag, each trial's
  balance flag.
* ``best_gap``: answers whose partition is not the best of their trials
  (balanced first, then the lowest cut; with none balanced, the lowest
  largest part, then the lowest cut).
* ``balance_excess_pct``: how far the largest part lies over the stated
  limit ``floor((1 + lam) * W / k)``, its product and quotient taken in
  float32 as the configuration states, in percent of that limit (at most 0
  when the guarantee holds).
* ``cut_ratio``: the cut over that of a plain geometric partition of the
  same graph (recursive coordinate bisection; the vertex id stands in for
  a coordinate where the class has no geometry).
"""
from __future__ import annotations

import torch

COUNTS = ("bad_answers", "report_gap", "best_gap")   # summed over answers
WORST = ("balance_excess_pct", "cut_ratio")          # worst answer's


def cut(lo, hi, w, parts) -> int:
    """Weight of the edges whose ends lie in different parts."""
    return int(torch.where(parts[lo] != parts[hi], w, 0).sum())


def largest_part(parts, k: int) -> int:
    """Vertex count of the largest part (every vertex weighs 1)."""
    return int(torch.bincount(parts, minlength=k).max())


def bisection(coords: torch.Tensor | None, n: int, k: int) -> torch.Tensor:
    """Recursive coordinate bisection into ``k`` parts: every group splits
    along its widest axis at the share of its vertices that its first half
    of the parts gets (ties broken by vertex id)."""
    if coords is None:
        coords = torch.arange(n, dtype=torch.float64).view(n, 1)
    gid = torch.zeros(n, dtype=torch.int64)
    gk = torch.tensor([k], dtype=torch.int64)
    vid = torch.arange(n)
    while bool((gk > 1).any()):
        groups = gk.numel()
        lo = torch.full((groups, coords.shape[1]), float("inf"),
                        dtype=torch.float64)
        hi = torch.full_like(lo, float("-inf"))
        idx = gid.view(n, 1).expand_as(coords)
        lo = lo.scatter_reduce(0, idx, coords, "amin")
        hi = hi.scatter_reduce(0, idx, coords, "amax")
        axis = torch.argmax(hi - lo, 1)
        key = coords[vid, axis[gid]]
        order = torch.argsort(key, stable=True)
        order = order[torch.argsort(gid[order], stable=True)]
        size = torch.bincount(gid, minlength=groups)
        start = torch.cumsum(size, 0) - size
        pos = torch.empty(n, dtype=torch.int64)
        pos[order] = torch.arange(n)
        pos -= start[gid]
        k1 = torch.where(gk > 1, gk // 2, gk)
        split = torch.where(gk > 1, size * k1 // torch.clamp(gk, min=1), size)
        gid = 2 * gid + (pos >= split[gid]).long()
        gk = torch.stack([k1, gk - k1], 1).view(-1)
    return torch.unique(gid, return_inverse=True)[1]


class Graph:
    """One graph of the benchmark as the reference sees it (host tensors)."""

    def __init__(self, el, k: int):
        self.n = el.n
        self.lo, self.hi, self.w = (t.cpu() for t in (el.lo, el.hi, el.w))
        self.total_w = int(self.w.sum())
        coords = None if el.coords is None else el.coords.cpu()
        self.ref_cut = max(cut(self.lo, self.hi, self.w,
                               bisection(coords, self.n, k)), 1)


def judge(g: Graph, answer, k: int, lam: float, trials: int) -> dict:
    """The readings of one answer.  ``answer`` holds host tensors and
    numbers: ``parts`` (n,), ``trial_parts`` (T, n), ``cut``, ``balanced``,
    ``trial_cuts``, ``trial_balanced``, ``best_trial``; or is None."""
    out = dict.fromkeys(COUNTS, 0) | {"cut": 0, "total_w": g.total_w}
    out |= dict.fromkeys(WORST, float("nan"))
    if answer is None or not _well_formed(g, answer, k, trials):
        out["bad_answers"] = 1
        return out
    limit = int(torch.floor((1.0 + lam) * torch.tensor(float(g.n)) / k))

    def reading(parts):
        big = largest_part(parts, k)
        return cut(g.lo, g.hi, g.w, parts), big <= limit, big

    c, bal, big = reading(answer["parts"])
    per_trial = [reading(p) for p in answer["trial_parts"]]
    gaps = [c != answer["cut"], bal != answer["balanced"]]
    for (tc, tb, _), rc, rb in zip(per_trial, answer["trial_cuts"],
                                   answer["trial_balanced"]):
        gaps += [tc != rc, tb != rb]
    out["report_gap"] = sum(bool(x) for x in gaps)
    if any(tb for _, tb, _ in per_trial):
        best = (True, min(tc for tc, tb, _ in per_trial if tb))
        got = (bal, c)
    else:
        low = min(tbig for _, _, tbig in per_trial)
        best = (low, min(tc for tc, _, tbig in per_trial if tbig == low))
        got = (big, c)
    out["best_gap"] = int(got != best)
    out["balance_excess_pct"] = 100.0 * (big / limit - 1.0)
    out["cut_ratio"] = c / g.ref_cut
    out["cut"] = c
    return out


def _well_formed(g: Graph, a, k: int, trials: int) -> bool:
    parts, tp = a.get("parts"), a.get("trial_parts")
    if parts is None or tp is None or tuple(parts.shape) != (g.n,) or \
            tuple(tp.shape) != (trials, g.n):
        return False
    if len(a.get("trial_cuts", ())) != trials or \
            len(a.get("trial_balanced", ())) != trials:
        return False
    for p in (parts, tp):
        if bool(((p < 0) | (p >= k)).any()):
            return False
    best = a.get("best_trial")
    if not isinstance(best, int) or not 0 <= best < trials:
        return False
    return bool(torch.equal(parts, tp[best]))


def summarize(readings: list[dict]) -> dict:
    """The numbers compared: counts summed, worst readings maximised."""
    out = {name: sum(r[name] for r in readings) for name in COUNTS}
    for name in WORST:
        vals = [r[name] for r in readings if r[name] == r[name]]
        out[name] = max(vals) if vals else float("nan")
    return out
