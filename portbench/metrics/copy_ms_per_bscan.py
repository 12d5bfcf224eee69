"""copy_ms_per_bscan: the device time of the traced window's host-to-device
and device-to-host copies per useful B-scan served."""


def _is_copy(name):
    return "HtoD" in name or "DtoH" in name


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("useful_bscans"):
        return None
    return 1e3 * trace.seconds(_is_copy) / ctx["useful_bscans"]
