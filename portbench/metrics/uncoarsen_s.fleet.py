"""Seconds of uncoarsening in one ``partition_fleet`` call, per graph: the
program's own span, ``FleetResult.times["uncoarsen_s"]``."""


def read(ctx):
    if ctx["mode"] != "fleet":
        return None
    return ctx["plain"]["times"]["uncoarsen_s"] / ctx["graphs"]
