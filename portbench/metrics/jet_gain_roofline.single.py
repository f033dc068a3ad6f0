"""jet_gain's share of its roofline (%) over one ``partition()`` call; see
``_roofline.py``."""
from _roofline import share


def read(ctx):
    return None if ctx["mode"] == "fleet" else share(ctx)
