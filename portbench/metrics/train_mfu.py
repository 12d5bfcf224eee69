"""train_mfu: the model FLOPs of the traced window's steps (3 x the
forward of every B-scan) per second of that window, as a share of the
card's dense peak for the cell's precision."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "steps" not in ctx:
        return None
    rate = 3 * ctx["steps"] * ctx["batch_size"] * ctx["forward_flops"] / trace.window_s
    return 100.0 * rate / ctx["peak_flops"]
