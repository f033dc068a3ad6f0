"""Seconds of uncoarsening (projection and Jet refinement of every level)
in one ``partition()`` call: the program's own span,
``PartitionResult.times["uncoarsen_s"]``."""


def read(ctx):
    if ctx["mode"] == "fleet":
        return None
    return ctx["plain"]["times"]["uncoarsen_s"]
