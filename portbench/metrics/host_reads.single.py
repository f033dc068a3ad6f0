"""Synchronizing device-to-host reads in one ``partition()`` call, counted
with CUDA's sync debug mode (a count that repeats for one seed)."""


def read(ctx):
    if ctx["mode"] == "fleet" or ctx["host_reads"] is None:
        return None
    return ctx["host_reads"]
