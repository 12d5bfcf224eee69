#!/usr/bin/env python3
"""Where a serving cell's idle card time goes, by the port's spans.

    python3 tools/torch_serve_idle_account.py --workload unet-cubes \
        [--seed 2147493001] [--seconds 8] [--out idle_unet-cubes.json]

Builds the benchmark cell as ``portbench/drivers/serve_volumes.py`` does
(pool, weights and BatchNorm statistics from the seed, ``VolumeSegmenter``,
two warm-up volumes), then serves its volumes closed-loop for
``--seconds`` under ``common.profiling.trace`` (a ``torch.profiler``
capture, written to ``build/idle_account/<workload>.json``), so the
program's spans (``serve.*``) are on. From the trace's device events
(kernels, copies, memsets) and the recorded spans, both on the Unix
clock, it gives each stretch of the window in which the card runs nothing
to the innermost span open on the serving thread (a model's own spans,
such as TransUNet's ``transunet.*`` under ``serve.forward``, included),
and prints, per span, its share of the idle time and its idle ms per
served B-scan, beside the spans' own totals and the per-layer readings
the benchmark takes from them (None where the cell has no such span). It
needs the card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside serve.volume"


def build(cell):
    """``(segmenter, volumes, schedule)`` of the cell, warmed up."""
    import importlib

    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter
    from portbench.drivers import serve_volumes
    from portbench.harness import data, judge

    kw, t = cell.model, cell.traffic
    ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    pool, _labels = data.make_pool(cell.seed, cell.config, t)
    weights = data.make_weights(ref.param_spec(kw), cell.seed, cell.device)
    data.calibrate(ref, weights, kw, judge.gray_to_input(pool[: t["batch_size"]], kw["input_channels"]), cell.device)
    name = cell.config["model"]["name"]
    module = get_model_class(name)(**kw).build_model(device=cell.device)
    module.load_state_dict(weights)
    segmenter = VolumeSegmenter(
        LoadedModel(name, module, dict(kw)), dict(kw), batch_size=t["batch_size"],
        minpath_tie_parity=t["tie_parity"], compute_dtype=cell.config["dtype"], device=cell.device,
    )
    vols = serve_volumes.volumes(cell, pool)
    smallest = min(range(len(vols)), key=lambda i: len(vols[i][0]))
    for _ in range(2):
        segmenter.segment_volume(vols[smallest][1])
    return segmenter, vols, serve_volumes.order(cell, blocks=1000)


def innermost_timeline(records):
    """``[(start, end, name)]`` covering the records' extent: in each
    stretch, the innermost open span (they nest on one thread), or
    ``OUTSIDE``."""
    marks = sorted([(r.start_ns, 1, i) for i, r in enumerate(records)]
                   + [(r.end_ns, 0, i) for i, r in enumerate(records)])
    out, stack, last = [], [], None
    for t, kind, i in marks:
        if last is not None and t > last:
            out.append((last, t, records[stack[-1]].name if stack else OUTSIDE))
        if kind:
            stack.append(i)
        else:
            stack.remove(i)
        last = t
    return out


def idle_intervals(events, base_ns, w0, w1):
    """``(idle stretches, busy ns)`` of ``[w0, w1)`` (Unix ns): the
    stretches with no device event, and the length of the union of those
    events."""
    busy = []
    for a, b in sorted((int(e["ts"] * 1e3) + base_ns, int((e["ts"] + e.get("dur", 0.0)) * 1e3) + base_ns)
                       for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return idle, sum(b - a for a, b in busy)


def attribute(idle, timeline):
    """Idle ns per innermost span name (two sorted interval lists merged)."""
    by, j = {}, 0
    for a, b in idle:
        while j < len(timeline) and timeline[j][1] <= a:
            j += 1
        k = j
        while k < len(timeline) and timeline[k][0] < b:
            s, e, name = timeline[k]
            by[name] = by.get(name, 0) + min(b, e) - max(a, s)
            k += 1
    return by


def account(cell, seconds: float, trace_dir: Path) -> dict:
    from oct_image_segmentation_models_torch.common import profiling
    from portbench.harness import spans as span_readers
    from portbench.run import read_metric

    segmenter, vols, schedule = build(cell)
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    profiling.reset_spans()
    served = 0
    trace_name = f"{cell.workload}.json"
    with profiling.trace(trace_dir, trace_name):
        t0 = time.perf_counter()
        for k in schedule:
            idx, vol = vols[k]
            segmenter.segment_volume(vol)
            served += len(idx)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    trace = json.loads((trace_dir / trace_name).read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    me = threading.get_ident()
    records = sorted((r for r in profiling.spans() if r.thread == me), key=lambda r: r.start_ns)
    volumes = [r for r in records if r.name == "serve.volume"]
    w0, w1 = volumes[0].start_ns, volumes[-1].end_ns
    idle, busy_ns = idle_intervals(trace["traceEvents"], base, w0, w1)
    by = attribute(idle, innermost_timeline(records))
    idle_ns = sum(b - a for a, b in idle)
    totals = profiling.span_totals()
    bscans = span_readers.served_bscans(totals)
    # The recorder's clock against the trace's: each serve.volume record
    # beside its exported user_annotation.
    exported = sorted(int(e["ts"] * 1e3) + base for e in trace["traceEvents"]
                      if e.get("cat") == "user_annotation" and e.get("name") == "serve.volume")
    offsets = sorted((r.start_ns - ts) / 1e3 for r, ts in zip(volumes, exported))
    return {
        "workload": cell.workload, "seed": cell.seed, "card": torch.cuda.get_device_name(0)
        if cell.device.type == "cuda" else "cpu",
        "window_s": (w1 - w0) / 1e9, "host_window_s": window_s, "bscans": bscans, "served": served,
        "bscans_per_s": bscans / ((w1 - w0) / 1e9), "busy_share": busy_ns / (w1 - w0),
        "idle_share": idle_ns / (w1 - w0), "idle_ms_per_bscan": idle_ns / 1e6 / bscans,
        "idle_by_span": {n: {"share_of_idle": v / idle_ns, "ms_per_bscan": v / 1e6 / bscans}
                         for n, v in sorted(by.items(), key=lambda kv: -kv[1])},
        "clock_offset_us": {"median": offsets[len(offsets) // 2], "max_abs": max(map(abs, offsets))},
        "longest_idle_ms": sorted(((b - a) / 1e6 for a, b in idle), reverse=True)[:10],
        "spans": {n: {"count": t["count"], "total_ms_per_bscan": t["total_ns"] / 1e6 / bscans,
                      "self_ms_per_bscan": t["self_ns"] / 1e6 / bscans, "counts": t["counts"]}
                  for n, t in totals.items()},
        "readings": {n: read_metric(n, {}) for n in
                     ("stage_ms_per_bscan", "fetch_ms_per_bscan", "launch_ms_per_batch",
                      "encoder_launch_ms_per_batch")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147493001)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_idle_account: no CUDA device", file=sys.stderr)
        return 2
    from portbench.harness.cell import Cell, load_json
    from portbench.run import cell_entries

    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    w, config_entry, _e2e, _layer = cell_entries(manifest, args.workload)
    config = json.loads((REPO / config_entry["file"]).read_text())
    cell = Cell(args.workload, config, load_json("traffic", w["traffic"]), args.seed, args.seconds,
                True, torch.device("cuda", 0), {})
    torch.set_num_threads(1)  # as the benchmark runs
    result = account(cell, args.seconds, REPO / "build" / "idle_account")
    text = json.dumps(result, indent=1, default=str)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
