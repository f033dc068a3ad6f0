"""Seconds the refinement loop's host was blocked at its per-iteration
read in one ``partition()`` call (the device's backlog at each iteration's
end), summed over the levels, ``times["refine_wait_s"]``.  Nothing where
the program keeps no such span."""


def read(ctx):
    if ctx["mode"] == "fleet":
        return None
    return ctx["plain"]["times"].get("refine_wait_s")
