"""launch_ms_per_batch: the host's time enqueueing the fused chain on one
batch (the mean duration of the program's ``serve.launch`` spans, in
which the forward, the boundary maps and the min-path are launched) in
the traced window."""

from portbench.harness import spans


def read(ctx):
    launch = spans.totals().get("serve.launch")
    if not launch or not launch["count"]:
        return None
    return launch["total_ns"] / 1e6 / launch["count"]
