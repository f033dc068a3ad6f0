"""jet_gain's share of its roofline over one call: the sum of every
launch's least time, its bytes (the benchmark's frozen formula over the
level's real rows and slots) at the card's peak bandwidth, over jet_gain's
device time in the profiler's trace.  Nothing when the trace shows no
jet_gain time, or the launches the levels account for are not the ones
the program counted."""
from costs import jet_gain_bytes


def share(ctx):
    prof = ctx["profile"]
    groups = prof["launch_groups"]
    if sum(g["launches"] for g in groups) != prof["jet_gain_launches"]:
        return None
    device_s = sum(s for name, s in prof["device_ops"].items()
                   if "jet_gain" in name)
    if device_s <= 0:
        return None
    bound_s = sum(g["launches"] * jet_gain_bytes(g["trials"], g["rows"],
                                                 g["slots"])
                  for g in groups) / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / device_s
