"""Host microseconds a jet_gain launch takes in one ``partition()`` call:
the host time in the wrapper (the check, the custom op's dispatch, the
ctypes launch), ``times["jet_gain_host_s"]``, over the launches the plain
call made.  Nothing without a launch, or where the program keeps no such
span."""


def read(ctx):
    if ctx["mode"] == "fleet":
        return None
    host_s = ctx["plain"]["times"].get("jet_gain_host_s")
    launches = ctx["profile"]["jet_gain_launches"]
    if host_s is None or not launches:
        return None
    return 1e6 * host_s / launches
