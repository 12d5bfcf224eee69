"""attention_roofline: the least time the attention of the traced window
could take on the card, as a share of the device time of the fused
attention kernel.

The work is the window's computed B-scans (padding included: the kernel
computes it) times ``reference/transunet.py::attention_flops``, ``layers *
4 * N^2 * hidden`` a B-scan (q k^T and the weights times v, 2 a
multiply-add), at the peak of the cell's precision (495 TFLOP/s for
float32, dense TF32; the memory-efficient kernel multiplies float32 in
3xTF32 on the tensor cores). The kernel is matched by name (``fmha``, ``attention`` or
``flash``, as PyTorch's fused attention kernels are named); the reading is
None where its launches differ from the summed ``layers`` count of the
program's ``transunet.encoder`` spans, one launch a layer and batch, so
that a name matching another kernel, or attention run unfused (the math
path's GEMMs), reads as nothing. The configuration is the TransUNet of
``BENCHMARK.json`` whose model FLOPs the context carries."""

import json
from pathlib import Path

from portbench.harness import flops, spans
from portbench.reference import transunet

ROOT = Path(__file__).resolve().parents[2]


def is_attention(name: str) -> bool:
    lower = name.lower()
    return any(key in lower for key in ("fmha", "attention", "flash"))


def _config(forward_flops: int):
    """The model kwargs of the one TransUNet configuration with these model
    FLOPs a B-scan, or None."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = []
    for entry in manifest["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        if config["model"]["name"] == "transunet" and flops.forward_flops(config) == forward_flops:
            found.append(config["model"]["kwargs"])
    return found[0] if len(found) == 1 else None


def read(ctx):
    trace = ctx.get("trace")
    encoder = spans.totals().get("transunet.encoder")
    if trace is None or not encoder or "computed_bscans" not in ctx:
        return None
    cfg = _config(ctx["forward_flops"])
    launches = trace.count(is_attention)
    seconds = trace.seconds(is_attention)
    if cfg is None or not launches or seconds <= 0 or launches != encoder["counts"].get("layers"):
        return None
    need = ctx["computed_bscans"] * transunet.attention_flops(cfg, ctx["height"], ctx["width"])
    return 100.0 * (need / ctx["peak_flops"]) / seconds
