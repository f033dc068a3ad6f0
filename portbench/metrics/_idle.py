"""The device's idle share of one call: 1 less the union of the device's
operations in the profiler's trace over the call's wall time, which is
taken from the same call, of the same seed, run without the profiler (so
the profiler's own host work does not count as idle)."""


def idle_pct(ctx):
    busy, wall = ctx["profile"]["busy_s"], ctx["wall_s"]
    if busy <= 0 or wall <= 0 or busy > wall:
        return None
    return 100.0 * (1.0 - busy / wall)
