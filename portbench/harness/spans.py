"""The program's own spans (``common/profiling.py`` of the port), which it
records while a ``torch.profiler`` session runs: in a traced run, the
window's. A checkout whose port records no spans reads as nothing."""

from __future__ import annotations


def totals() -> dict:
    """``span_totals()`` of the port: per span name ``count``,
    ``total_ns``, ``self_ns`` and the sums of its ``counts``; empty where
    the port has no span recorder."""
    from oct_image_segmentation_models_torch.common import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def served_bscans(t: dict) -> int:
    """The B-scans of the requests served under ``serve.volume`` spans."""
    return t.get("serve.volume", {}).get("counts", {}).get("bscans", 0)


def self_ms_per_bscan(names) -> float | None:
    """The self time of the spans ``names``, summed, per served B-scan, in
    ms; None where none of them or no request was recorded."""
    t = totals()
    found = [t[n] for n in names if n in t]
    bscans = served_bscans(t)
    if not found or not bscans:
        return None
    return sum(s["self_ns"] for s in found) / 1e6 / bscans
