"""The device's idle share (%) of one ``partition()`` call; see
``_idle.py``."""
from _idle import idle_pct


def read(ctx):
    return None if ctx["mode"] == "fleet" else idle_pct(ctx)
