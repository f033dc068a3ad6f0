"""Synchronizing host reads in one ``partition()`` call, counted by the
program where each happens (``repro_torch.trace.read``):
``times["host_reads"]`` of the plain call.  Nothing where the program keeps
no such count."""


def read(ctx):
    if ctx["mode"] == "fleet":
        return None
    return ctx["plain"]["times"].get("host_reads")
