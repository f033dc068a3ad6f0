"""Refinement iterations of one ``partition()`` call: over the levels, the
loop's iterations (the most any trial ran), from the program's
``level_stats``.  A count that repeats exactly for one seed."""


def read(ctx):
    if ctx["mode"] == "fleet":
        return None
    return ctx["plain"]["iterations"]
