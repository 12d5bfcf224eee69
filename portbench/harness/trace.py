"""The traced run's device trace: ``torch.profiler`` over the measured
window, exported as Chrome trace JSON and reduced here.

The window is the benchmark's ``record_function("window")`` span. Device
activity is every kernel, copy and memset; the busy time is the length of
their union inside the window, so overlapping kernels count once. An idle
gap is named by the innermost of the benchmark's own spans that was open
on the host when the gap began.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("assemble", "segment_volume", "step", "next_batch", "window")
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    by_name: dict = field(default_factory=dict)  # device op name -> seconds
    gaps: list = field(default_factory=list)  # [(span name, seconds)], longest first
    counts: dict = field(default_factory=dict)  # device op name -> launches

    def seconds(self, match) -> float:
        """Device seconds of the ops whose name ``match(name)`` accepts."""
        return sum(s for name, s in self.by_name.items() if match(name))

    def count(self, match) -> int:
        return sum(n for name, n in self.counts.items() if match(name))

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [list(g) for g in self.gaps[:TOP]]}


@contextlib.contextmanager
def capture(enabled: bool, out: list):
    """Profile the block when ``enabled``; append the reduced :class:`Trace`
    to ``out`` once it ends."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
    prof.start()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    out.append(reduce_events(events))


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events: list) -> Trace:
    """Chrome trace events (µs) -> :class:`Trace` of the window."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") in SPANS]
    windows = [e for e in spans if e["name"] == "window"]
    if not windows:
        raise RuntimeError("the trace holds no 'window' span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    by_name, counts, intervals = {}, {}, []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    merged = _union(intervals)
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans if e["name"] != "window")
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a), key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:TOP]:
        open_ = [s for s in host if s[0] <= a < s[1]]
        named.append((max(open_, key=lambda s: s[0])[2] if open_ else "window", (b - a) * 1e-6))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy, by_name=by_name, gaps=named, counts=counts)
