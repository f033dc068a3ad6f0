"""Seconds of coarsening in one ``partition_fleet`` call, per graph: the
program's own span, ``FleetResult.times["coarsen_s"]``."""


def read(ctx):
    if ctx["mode"] != "fleet":
        return None
    return ctx["plain"]["times"]["coarsen_s"] / ctx["graphs"]
