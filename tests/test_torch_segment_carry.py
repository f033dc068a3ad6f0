"""A numpy model of the segment_reduce kernel's decomposition, at tiny tiles.

``kernels/segment_reduce/segment_reduce.cu`` cuts the rows and the outputs
of a sorted-segment sum along their merge path (rows of id 0, output 0,
rows of id 1, output 1, ...), so that each tile holds the same number of
merged items.  Three kernels: ``splits_pass`` searches each tile's first
row; ``tiles_pass`` (F = 1) and ``tiles_pass_wide`` (F > 1) sum the tile's
rows, write every output of the tile but its first (zeros where a segment
is empty) and leave the tile's lead (its first output's partial) and trail
(the rows after its last output) in per-tile arrays; ``carry_pass``
scans (tile has an output, trail) in tile order and writes each tile's
first output.  The CUDA code runs only on the card; this model mirrors it
step for step (the 4-ary split search, the rows a thread holds, the lane
scan, the warp prefixes, the sinks, the carry's slices and its two-level
scan) with tiles of a few items, and is held against the plain version
``segment_sum_sorted_ref``: int32 exactly, float32 within 1e-5 + 1e-5 *
(the sum of |x| over the segment).  Every output must be written once.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref  # noqa: E402,E501

INT_MAX = 2**31 - 1
# the kernel's geometry is 32 lanes, 8 warps and up to 16 rows a thread
# (4092 items a tile), 65536 values a tile at F > 1, and 16 carry warps
# of 32 lanes with windows of 3584 tiles; the model's is tiny
LANES, WARPS, ROWS, VEC = 2, 2, 8, 4
ITEMS = LANES * WARPS * ROWS - VEC    # 28
WIDE_ELEMS = 40
CARRY_WARPS, CARRY_LANES, CARRY_WINDOW = 3, 2, 10


def add(a, b, dtype):
    if dtype == np.int32:                     # two's complement wrap
        return (int(a) + int(b) + 2**31) % 2**32 - 2**31
    return np.float32(a) + np.float32(b)


def combine(a, b, dtype):
    """Segmented sum of two spans: (a run starts inside, sum since)."""
    return (a[0] | b[0], b[1] if b[0] else add(a[1], b[1], dtype))


def tile_items(f):
    return ITEMS if f == 1 else max(4, min(ITEMS, WIDE_ELEMS // f))


def merge_pos(seg, r, s):
    return r + min(max(int(seg[r]), 0), s)


def rows_before(seg, m, s, d):
    """splits_pass: the first row whose merged position is >= d, down one
    4-ary tree over [0, m] (3 probes a step), then a binary search."""
    lo, hi = 0, m
    while hi - lo >= 4:
        q = (hi - lo) // 4
        c = sum(merge_pos(seg, lo + k * q, s) < d for k in (1, 2, 3))
        lo, hi = (lo + c * q + 1 if c > 0 else lo,
                  lo + (c + 1) * q if c < 3 else hi)
    while lo < hi:
        mid = (lo + hi) // 2
        if merge_pos(seg, mid, s) >= d:
            hi = mid
        else:
            lo = mid + 1
    return lo


class Model:
    def __init__(self, data, seg, s):
        self.data, self.seg, self.s = data, seg, s
        self.m, self.f = data.shape
        self.dtype = data.dtype.type
        self.out = np.zeros((s, self.f), data.dtype)
        self.writes = np.zeros((s, self.f), np.int64)
        self.items = tile_items(self.f)
        self.tiles = -(-(self.m + s) // self.items)
        self.lead = np.full((self.tiles, self.f), 99, data.dtype)
        self.trail = np.full((self.tiles, self.f), 99, data.dtype)
        self.splits = [0] + [rows_before(seg, self.m, s, b * self.items)
                             for b in range(1, self.tiles)] + [self.m]

    def bounds(self, b):
        d0 = b * self.items
        d1 = min(d0 + self.items, self.m + self.s)
        i0, i1 = self.splits[b], self.splits[b + 1]
        return i0, i1, d0 - i0, d1 - i1

    def store(self, j, c, x):
        self.out[j, c] = x
        self.writes[j, c] += 1

    def sink(self, b, j0, j1, sid, c, x):
        """Where a run's sum goes (``Sink::slot``)."""
        if sid == j1 and j1 < self.s:
            self.trail[b, c] = x
        elif j0 <= sid < j1:
            if sid == j0 and b > 0:
                self.lead[b, c] = x
            else:
                self.store(sid, c, x)

    def tile_narrow(self, b):
        """tiles_pass: thread t holds q consecutive rows from a0 + t q."""
        dt, seg, data = self.dtype, self.seg, self.data[:, 0]
        i0, i1, j0, j1 = self.bounds(b)
        no = j1 - j0
        outv = [dt(0)] * no
        trail_v = dt(0)
        a0 = i0 & ~(VEC - 1)
        per_thread = -(-(i1 - a0) // (LANES * WARPS))
        q = max(VEC, -(-per_thread // VEC) * VEC)
        assert q <= ROWS and a0 + LANES * WARPS * q >= i1

        def row(r):
            return (int(seg[r]), data[r]) if r < self.m else (INT_MAX, dt(0))

        threads = []                     # per thread: (agg, its rows)
        for t in range(LANES * WARPS):
            mine, rows = (0, dt(0)), []
            for r in range(a0 + t * q, a0 + (t + 1) * q):
                valid = i0 <= r < i1
                h = valid and (r == i0 or row(r - 1)[0] != row(r)[0])
                tl = valid and (r == i1 - 1 or row(r + 1)[0] != row(r)[0])
                x = row(r)[1] if valid else dt(0)
                mine = (mine[0] | h, x if h else add(mine[1], x, dt))
                rows.append((r, tl, not mine[0], mine[1]))
            threads.append((mine, rows))
        incl, warp_agg = [], []
        for w in range(WARPS):           # shuffle scan over a warp's lanes
            lane = [threads[w * LANES + ln][0] for ln in range(LANES)]
            off = 1
            while off < LANES:
                lane = [combine(lane[ln - off], lane[ln], dt) if ln >= off
                        else lane[ln] for ln in range(LANES)]
                off *= 2
            incl += lane
            warp_agg.append(lane[-1])
        for t, (_, rows) in enumerate(threads):
            w, ln = divmod(t, LANES)
            pre = (0, dt(0))
            for agg in warp_agg[:w]:
                pre = combine(pre, agg, dt)
            if ln > 0:
                pre = combine(pre, incl[t - 1], dt)
            for r, tl, is_open, val in rows:
                if not tl:
                    continue
                x = add(pre[1], val, dt) if is_open else val
                sid = int(seg[r])
                if sid == j1 and j1 < self.s:
                    trail_v = x
                elif j0 <= sid < j1:
                    outv[sid - j0] = x
        for e in range(1 if b > 0 else 0, no):
            self.store(j0 + e, 0, outv[e])
        self.lead[b, 0] = outv[0] if no > 0 else dt(0)
        self.trail[b, 0] = trail_v

    def tile_wide(self, b):
        """tiles_pass_wide: a row group per warp, lanes on columns."""
        dt, f = self.dtype, self.f
        i0, i1, j0, j1 = self.bounds(b)
        no, nr = j1 - j0, i1 - i0
        sid = [int(x) for x in self.seg[i0:i1]]
        present = [False] * (no + 1)
        flags = []
        for r, s in enumerate(sid):
            flags.append((r == 0 or sid[r - 1] != s, r == nr - 1
                          or sid[r + 1] != s))
            if j0 <= s <= j1:
                present[s - j0] = True
        for o in range(no):
            if not present[o]:
                for c in range(f):
                    if o > 0 or b == 0:
                        self.store(j0 + o, c, dt(0))
                    else:
                        self.lead[b, c] = dt(0)
        if not (j1 < self.s and present[no]):
            self.trail[b] = dt(0)
        if no == 0 and b > 0:
            self.lead[b] = dt(0)
        for c in range(f):
            gout, gstate, closing = [], [], []
            for w in range(WARPS):
                rb, re = nr * w // WARPS, nr * (w + 1) // WARPS
                acc, started, closed = dt(0), False, None
                for r in range(rb, re):
                    x = self.data[i0 + r, c]
                    h, t = flags[r]
                    if h:
                        acc, started = x, True
                    else:
                        acc = add(acc, x, dt)
                    if t:
                        if started:
                            self.sink(b, j0, j1, sid[r], c, acc)
                        else:
                            closed = (sid[r], acc)
                gout.append(acc)
                gstate.append((re > rb, started))
                closing.append(closed)
            for w, closed in enumerate(closing):
                if closed is None:
                    continue
                s, tot = closed
                for v in range(w - 1, -1, -1):
                    if not gstate[v][0]:
                        continue
                    tot = add(gout[v], tot, dt)
                    if gstate[v][1]:
                        break
                self.sink(b, j0, j1, s, c, tot)

    def carry(self):
        """carry_pass.  F = 1: windows of CARRY_WINDOW tiles, a slice of
        the window per thread, a scan over the lanes of a warp, the warps'
        totals (the kernel's copies of this block only share the stores);
        F > 1: warp w takes the w-th of CARRY_WARPS slices of the
        tiles, lanes on columns, and the warps' totals join them."""
        dt = self.dtype
        threads = CARRY_WARPS * CARRY_LANES

        def first_out(b):
            j = min(b * self.items, self.m + self.s) - self.splits[b]
            has = min((b + 1) * self.items, self.m + self.s) \
                - self.splits[b + 1] > j
            return j if has else -1

        def pair(b, c):
            return (first_out(b) >= 0, self.trail[b, c])

        def write(b, c, pre):
            if first_out(b) >= 0 and b > 0:
                self.store(first_out(b), c, add(pre[1], self.lead[b, c], dt))

        if self.f == 1:
            window = (0, dt(0))
            for ws in range(0, self.tiles, CARRY_WINDOW):
                wn = min(CARRY_WINDOW, self.tiles - ws)
                per = -(-wn // threads)
                slices = [range(ws + min(t * per, wn), ws + min(t * per + per,
                                                              wn))
                          for t in range(threads)]
                mine = []
                for sl in slices:
                    r = (0, dt(0))
                    for b in sl:
                        r = combine(r, pair(b, 0), dt)
                    mine.append(r)
                incl, wtot = [], []
                for w0 in range(0, threads, CARRY_LANES):
                    lane, off = mine[w0:w0 + CARRY_LANES], 1
                    while off < CARRY_LANES:
                        lane = [combine(lane[i - off], lane[i], dt)
                                if i >= off else lane[i]
                                for i in range(CARRY_LANES)]
                        off *= 2
                    incl += lane
                    wtot.append(lane[-1])
                for t, sl in enumerate(slices):
                    pre = window
                    for tot in wtot[:t // CARRY_LANES]:
                        pre = combine(pre, tot, dt)
                    if t % CARRY_LANES:
                        pre = combine(pre, incl[t - 1], dt)
                    for b in sl:
                        write(b, 0, pre)
                        pre = combine(pre, pair(b, 0), dt)
                for tot in wtot:
                    window = combine(window, tot, dt)
            return
        per = -(-self.tiles // CARRY_WARPS)
        slices = [range(min(w * per, self.tiles), min(w * per + per,
                                                      self.tiles))
                  for w in range(CARRY_WARPS)]
        for c in range(self.f):
            wtot = []
            for sl in slices:
                agg = (0, dt(0))
                for b in sl:
                    agg = combine(agg, pair(b, c), dt)
                wtot.append(agg)
            for w, sl in enumerate(slices):
                carry = (0, dt(0))
                for tot in wtot[:w]:
                    carry = combine(carry, tot, dt)
                for b in sl:
                    write(b, c, carry)
                    carry = combine(carry, pair(b, c), dt)

    def run(self):
        if self.s == 0 or self.f == 0:
            return self.out
        for b in range(self.tiles):
            self.tile_narrow(b) if self.f == 1 else self.tile_wide(b)
            d = self.bounds(b)
            assert d[1] - d[0] + d[3] - d[2] <= self.items   # bounded tile
        if self.tiles > 1:
            self.carry()
        assert (self.writes == 1).all(), "every output is written once"
        return self.out


def check(data, seg, s):
    """The model against the plain version; returns the model's output."""
    got = Model(data, seg, s).run()
    want = segment_sum_sorted_ref(torch.from_numpy(data),
                                  torch.from_numpy(seg), s).numpy()
    assert got.shape == want.shape == (s, data.shape[1])
    if data.dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        bound = 1e-5 + 1e-5 * segment_sum_sorted_ref(
            torch.from_numpy(np.abs(data)), torch.from_numpy(seg), s).numpy()
        assert (np.abs(got - want) <= bound).all()
    return got


def values(rng, m, f, dtype):
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31, (m, f)).astype(np.int32)
    return rng.standard_normal((m, f)).astype(np.float32)


@pytest.mark.parametrize("kind", tp.SEGMENT_KINDS)
def test_model_matches_plain(kind):
    # the panels of the card tests, at tiny sizes, F = 1 and F > 1
    for m in (1, 3, 4, 5, 27, 28, 29, 64, 201):
        for f in (1, 3):
            for dtype in (torch.int32, torch.float32):
                data, seg, s = tp.segment_case(m, f, kind, dtype, seed=m + f,
                                               device="cpu")
                check(data.numpy(), seg.numpy(), s)


def test_run_starting_on_a_tile_first_row():
    # runs of length 7 with 28-item tiles: tile starts land on run starts,
    # on run ends and in between, for every offset of the first id
    rng = np.random.default_rng(0)
    for first in range(4):
        seg = np.repeat(np.arange(first, first + 30), 7).astype(np.int32)
        s = first + 31
        check(values(rng, seg.size, 1, np.int32), seg, s)
        check(values(rng, seg.size, 1, np.float32), seg, s)


def test_tiles_wholly_inside_one_run():
    # a run over many tiles, alone, after short runs, and before a long gap
    rng = np.random.default_rng(1)
    for seg, s in ((np.zeros(300, np.int32), 1),
                   (np.r_[np.arange(10), np.full(290, 12)].astype(np.int32),
                    13),
                   (np.r_[np.full(250, 3), [400]].astype(np.int32), 500)):
        for f in (1, 2, 5):
            check(values(rng, seg.size, f, np.int32), seg, s)
            check(values(rng, seg.size, f, np.float32), seg, s)


def test_long_gaps_are_zeroed_by_many_tiles():
    # the run-weight sum's shape: each trial's run ids end far below the
    # trial's block of ids; the gaps span many tiles of outputs only
    rng = np.random.default_rng(2)
    runs = [np.sort(rng.integers(0, 12, 40)) for _ in range(3)]
    seg = np.concatenate([r + 150 * t for t, r in enumerate(runs)])
    for f in (1, 3):
        got = check(values(rng, seg.size, f, np.int32), seg.astype(np.int32),
                    450)
        assert not got[12:150].any() and not got[312:].any()


def test_ids_dropped_at_both_ends():
    rng = np.random.default_rng(3)
    seg = np.r_[np.full(40, -7), [-1, -1, 0, 0, 0, 2], np.arange(3, 30),
                np.full(50, 31), np.full(60, 2**31 - 1)].astype(np.int32)
    for s in (1, 2, 30, 31, 32, 40):
        for f in (1, 4):
            check(values(rng, seg.size, f, np.int32), seg, s)
            check(values(rng, seg.size, f, np.float32), seg, s)


def test_empty_inputs():
    for f in (1, 3):
        check(np.zeros((0, f), np.int32), np.zeros(0, np.int32), 5)
        check(np.zeros((0, f), np.float32), np.zeros(0, np.int32), 100)
        check(np.ones((7, f), np.int32), np.zeros(7, np.int32), 0)
        # all rows dropped
        check(np.ones((9, f), np.int32), np.full(9, 5, np.int32), 5)
        check(np.ones((9, f), np.int32), np.full(9, -2, np.int32), 5)


def test_ragged_rows_and_unaligned_tile_starts():
    # M not a multiple of 4, and tiles whose first row is not either: the
    # model reads rows from the multiple of 4 below, as the kernel does
    rng = np.random.default_rng(4)
    for m in range(29, 45):
        seg = np.sort(rng.integers(0, m // 3 + 1, m)).astype(np.int32)
        check(values(rng, m, 1, np.int32), seg, m // 3 + 1)
        check(values(rng, m, 1, np.float32), seg, m // 3 + 2)


def test_splits_follow_the_merge_path():
    rng = np.random.default_rng(5)
    for s in (1, 9, 60):
        seg = np.sort(rng.integers(-3, s + 3, 97)).astype(np.int32)
        mod = Model(np.zeros((97, 1), np.int32), seg, s)
        for b in range(mod.tiles + 1):
            d = min(b * mod.items, 97 + s)
            i = mod.splits[b]
            # rows before the split precede position d, the rest do not
            assert all(merge_pos(seg, r, s) < d for r in range(i))
            assert all(merge_pos(seg, r, s) >= d for r in range(i, 97))
            assert 0 <= d - i <= s


def test_ghost_run_as_the_conn_self_sum_gives_it():
    # per trial: short runs by vertex, then the ghost vertex n over the
    # rest of the trial's rows; trial t's ids are offset by t * (n + 1)
    rng = np.random.default_rng(6)
    n, m_max, t = 9, 70, 3
    seg = []
    for tr in range(t):
        real = np.sort(rng.integers(0, n, 15))
        seg.append(np.r_[real, np.full(m_max - 15, n)] + tr * (n + 1))
    seg = np.concatenate(seg).astype(np.int32)
    got = check(values(rng, seg.size, 1, np.int32), seg, t * (n + 1))
    assert got.shape == (t * (n + 1), 1)


def test_int32_sums_wrap():
    data = np.full((200, 1), 2**30, np.int32)
    got = check(data, np.zeros(200, np.int32), 1)
    assert got[0, 0] == 0    # 200 * 2^30 wraps to 0, as XLA's int32 sum


def test_carry_slices_of_several_tiles():
    # more tiles than a carry window holds, and than carry threads
    rng = np.random.default_rng(7)
    seg = np.r_[np.full(900, 2), np.arange(3, 80).repeat(3)].astype(np.int32)
    data = values(rng, seg.size, 1, np.float32)
    mod = Model(data, seg, 81)
    assert mod.tiles > 2 * CARRY_WINDOW > 2 * CARRY_WARPS * CARRY_LANES
    got = mod.run()
    again = Model(data, seg, 81).run()
    assert np.array_equal(got.view(np.int32), again.view(np.int32))
    check(data, seg, 81)
