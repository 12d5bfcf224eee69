"""encoder_launch_ms_per_batch: the host's time enqueueing TransUNet's
embedding, its encoder blocks and the final LayerNorm on one batch (the
mean duration of the program's ``transunet.encoder`` spans,
``models/transunet.py``) in the traced window. Nothing where the program
records no such span."""

from portbench.harness import spans


def read(ctx):
    encoder = spans.totals().get("transunet.encoder")
    if not encoder or not encoder["count"]:
        return None
    return encoder["total_ns"] / 1e6 / encoder["count"]
