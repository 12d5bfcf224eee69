"""Closed-loop volume serving: one caller sends a volume of B-scans to
``VolumeSegmenter.segment_volume`` (``prediction/streaming.py``), waits for
its labels and rows on the host as numpy, then sends the next.

Traffic keys: ``pool`` (B-scans made from the seed), ``volume_bscans``
(the sizes of one block of requests), ``block_repeats`` (copies of each
size in a block), ``batch_size``, ``tie_parity``, ``sample_bscans`` (how
many served B-scans the check judges at least). Every block is the same
multiset of volumes in an order drawn from the seed; each volume's
B-scans are drawn from the pool. The window closes at the first reply
after ``--seconds``.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from portbench.harness import cell as cell_lib
from portbench.harness import data, flops, judge
from portbench.harness import trace as trace_lib


def volumes(cell, pool_images):
    """``[(pool indices, volume array)]``, one per request of a block."""
    t = cell.traffic
    sizes = [n for n in t["volume_bscans"] for _ in range(t["block_repeats"])]
    r = data.rng(cell.seed, data.ORDER + 16)
    out = []
    for n in sizes:
        start = int(r.integers(0, len(pool_images)))
        idx = (start + np.arange(n)) % len(pool_images)
        out.append((idx, np.ascontiguousarray(judge.gray_to_input(pool_images[idx], cell.model["input_channels"]))))
    return out


def order(cell, blocks: int):
    """Request indices of ``blocks`` blocks, each block in its own order."""
    per = len(cell.traffic["volume_bscans"]) * cell.traffic["block_repeats"]
    return data.block_order(cell.seed, list(range(per)), per * blocks)


def run(cell) -> cell_lib.Outcome:
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    dev, t, kw = cell.device, cell.traffic, cell.model
    ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    pool_images, _labels = data.make_pool(cell.seed, cell.config, t)
    marks = {"pool": time.perf_counter()}
    weights = data.make_weights(ref.param_spec(kw), cell.seed, dev)
    data.calibrate(ref, weights, kw, judge.gray_to_input(pool_images[: t["batch_size"]], kw["input_channels"]), dev)
    name = cell.config["model"]["name"]
    module = get_model_class(name)(**kw).build_model(device=dev)
    module.load_state_dict(weights)
    segmenter = VolumeSegmenter(
        LoadedModel(name, module, dict(kw)), dict(kw), batch_size=t["batch_size"],
        minpath_tie_parity=t["tie_parity"], compute_dtype=cell.config["dtype"], device=dev,
    )
    marks["build"] = time.perf_counter()
    vols = volumes(cell, pool_images)
    marks["volumes"] = time.perf_counter()
    # Warm-up: the smallest request of the mix, twice (every batch has the
    # cell's one shape; the smallest takes the padding path).
    smallest = min(range(len(vols)), key=lambda i: len(vols[i][0]))
    for _ in range(2):
        segmenter.segment_volume(vols[smallest][1])
    cell_lib.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    schedule = order(cell, blocks=1000)
    done, latency, traces = [], [], []
    before = cell_lib.launch_counts() if dev.type == "cuda" else {}
    t_start = time.perf_counter()
    setup_s = t_start - cell.started
    deadline = t_start + cell.seconds
    with trace_lib.capture(cell.trace, traces), torch.profiler.record_function("window"):
        for k in schedule:
            with torch.profiler.record_function("assemble"):
                idx, vol = vols[k]
            t0 = time.perf_counter()
            with torch.profiler.record_function("segment_volume"):
                labels, rows = segmenter.segment_volume(vol)
            t1 = time.perf_counter()
            done.append({"idx": idx, "labels": labels, "rows": rows})
            latency.append(t1 - t0)
            if t1 >= deadline:
                break
    window_s = t1 - t_start
    launches = {k: v - before[k] for k, v in cell_lib.launch_counts().items()} if before else {}
    peak = cell_lib.memory_peak(dev)
    del segmenter, module
    cell_lib.free(dev)

    served = sum(len(r["idx"]) for r in done)
    batches = sum(-(-len(r["idx"]) // t["batch_size"]) for r in done)
    readings = judge.serve_readings(ref, weights, kw, pool_images, done, cell.seed, t["sample_bscans"], dev)
    correct, checks = judge.checks(readings, cell.limits)
    e2e = {
        "serve_bscans_per_s": served / window_s,
        "request_p95_s": float(np.percentile(latency, 95)),
        "setup_s": setup_s,
    }
    trace = traces[0] if traces else None
    context = {
        "useful_bscans": served,
        "computed_bscans": batches * t["batch_size"],
        "forward_flops": flops.forward_flops(cell.config),
        "peak_flops": flops.PEAK_FLOPS[cell.config["dtype"]],
        "minpath_maps_per_launch": t["batch_size"] * (kw["num_classes"] - 1),
        "height": kw["image_height"],
        "width": kw["image_width"],
        "trace": trace,
    }
    marks["warm"] = t_start
    notes = {"setup_marks": {k: v - cell.started for k, v in marks.items()}, "requests": len(done),
             "bscans": served, "window_s": window_s, "launches": launches,
             "judged_bscans": readings["judged_bscans"]}
    return cell_lib.Outcome(e2e, context, len(done), readings["malformed"], correct, checks, peak, trace, notes)
