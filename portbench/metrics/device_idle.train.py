"""device_idle.train: the share of the traced window of a training cell in
which no kernel, copy or memset runs on the card."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "steps" not in ctx:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
