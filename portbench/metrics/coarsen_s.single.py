"""Seconds of coarsening in one ``partition()`` call: the program's own
span, ``PartitionResult.times["coarsen_s"]`` (a synced host clock)."""


def read(ctx):
    if ctx["mode"] == "fleet":
        return None
    return ctx["plain"]["times"]["coarsen_s"]
