"""Seconds the refinement loop's host spent issuing work in one
``partition()`` call: its host wall time less the time blocked at its
per-iteration read, summed over the levels, ``times["refine_issue_s"]``.
Nothing where the program keeps no such span."""


def read(ctx):
    if ctx["mode"] == "fleet":
        return None
    return ctx["plain"]["times"].get("refine_issue_s")
