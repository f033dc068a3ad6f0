"""jet_gain's share of its roofline (%) over one ``partition_fleet`` call;
see ``_roofline.py``."""
from _roofline import share


def read(ctx):
    return share(ctx) if ctx["mode"] == "fleet" else None
