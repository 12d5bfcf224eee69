"""train_backward_ms: the mean device time of the step's backward phase,
between the CUDA events the benchmark records at the step's own
``on_phase("forward")`` and ``on_phase("backward")`` hooks."""


def read(ctx):
    times = ctx.get("backward_ms") or []
    return sum(times) / len(times) if times else None
