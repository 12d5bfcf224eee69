"""serve_mfu: the model FLOPs of the useful B-scans the traced window
served (padding not counted) per second of that window, as a share of the
card's dense peak for the cell's precision."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "useful_bscans" not in ctx:
        return None
    rate = ctx["useful_bscans"] * ctx["forward_flops"] / trace.window_s
    return 100.0 * rate / ctx["peak_flops"]
