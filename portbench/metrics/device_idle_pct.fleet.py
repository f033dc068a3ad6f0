"""The device's idle share (%) of one ``partition_fleet`` call; see
``_idle.py``."""
from _idle import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx["mode"] == "fleet" else None
