"""stage_ms_per_bscan: the host's time padding volumes and staging batches
for upload (the self time of the program's ``serve.pad`` and
``serve.stage`` spans: the tail copies, ``pin_memory`` and the
non-blocking copy's enqueue) per useful B-scan served in the traced
window."""

from portbench.harness import spans


def read(ctx):
    return spans.self_ms_per_bscan(("serve.pad", "serve.stage"))
