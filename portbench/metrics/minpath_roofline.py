"""minpath_roofline: the least time the min-path calls of the traced
window could take on the card (each uint8 map read once and each int32
row written once, at the HBM's 3.35 TB/s), as a share of the device time
of the kernels named ``minpath_kernel`` (``csrc/minpath.cu``)."""

from portbench.harness.flops import HBM_BYTES_PER_S, minpath_bytes


def _is_minpath(name):
    return "minpath_kernel" in name


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "minpath_maps_per_launch" not in ctx:
        return None
    seconds = trace.seconds(_is_minpath)
    launches = trace.count(_is_minpath)
    if not launches or seconds <= 0:
        return None
    need = launches * minpath_bytes(ctx["minpath_maps_per_launch"], ctx["height"], ctx["width"])
    return 100.0 * (need / HBM_BYTES_PER_S) / seconds
