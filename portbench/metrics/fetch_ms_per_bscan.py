"""fetch_ms_per_bscan: the host's time bringing a volume's labels and rows
back as numpy (the self time of the program's ``serve.fetch`` spans:
``torch.cat``, the blocking ``.cpu()`` and the slicing) per useful B-scan
served in the traced window."""

from portbench.harness import spans


def read(ctx):
    return spans.self_ms_per_bscan(("serve.fetch",))
