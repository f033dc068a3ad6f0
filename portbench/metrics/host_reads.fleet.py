"""Synchronizing device-to-host reads of one ``partition_fleet`` call, per
graph of the fleet, counted with CUDA's sync debug mode."""


def read(ctx):
    if ctx["mode"] != "fleet" or ctx["host_reads"] is None:
        return None
    return ctx["host_reads"] / ctx["graphs"]
