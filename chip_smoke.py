#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which raises on failure:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel in
   ``oct_image_segmentation_models_torch/csrc`` (one ``nvcc`` per source,
   all started together).
2. Kernel parity: the CUDA min-path kernel against its plain PyTorch
   version on the same CUDA tensors, bit for bit, in both tie modes, at
   the flagship shape (24 maps x 1024 columns x 512 rows) and at odd ones.
3. The slice at full width: ``VolumeSegmenter`` with the bench's U-Net
   (start_neurons=32, pool_layers=4, conv_layers=2, 4 classes, 512x1024
   B-scans, batch 8, random weights from a seeded ``torch.Generator``)
   segments a 20-B-scan volume with fast ties and one batch with exact
   ties. The kernel's launch counter must have moved; the rows must equal
   the plain min-path run on maps rebuilt from the returned labels; one
   B-scan's probabilities on the card must agree with the CPU float32
   forward.
4. Times, with CUDA events (median of several runs after warm-up): the
   pipeline per batch, its stages, the kernel per call in each tie mode,
   the plain version, and the kernel's bound.

It prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits with code 2 and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W, BATCH, NUM_CLASSES = 512, 1024, 8, 4
VOLUME = 20  # two full batches and a remainder of 4
N_MAPS = BATCH * (NUM_CLASSES - 1)  # 24 maps per batch
# Card peaks for the bound (H100 SXM data sheet): 3.35 TB/s of HBM3;
# int32 ALU ops at half the 67 TFLOP/s float32 CUDA-core rate (64 INT32
# lanes per SM against 128 FP32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (TF32 is off)
# The card's float32 forward (cuDNN, TF32 off) against the CPU's: both
# float32, summed in another order over ~20 convs of depth up to 4608.
PROB_ATOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, reps: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` of the mean ms per call of ``fn``, each rep
    ``iters`` calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def smooth_rows(rng, n, w, h, max_step, margin=2):
    steps = rng.integers(-max_step, max_step + 1, size=(n, w))
    rows = rng.integers(margin, h - margin, size=(n, 1)) + np.cumsum(steps, 1)
    return np.clip(rows, margin, h - margin - 1)


def synthetic_maps(rng, family: str, n: int, w: int, h: int, max_step=2):
    """Min-path test maps ``(n, w, h)`` uint8: one-row ridges, 2-4-row
    plateau ridges (zero-weight-edge races), or sparse random 0/255."""
    if family == "sparse":
        return (rng.random((n, w, h)) < 0.15).astype(np.uint8) * 255
    maps = np.zeros((n, w, h), np.uint8)
    rows = smooth_rows(rng, n, w, h, max_step)
    maps[np.arange(n)[:, None], np.arange(w)[None, :], rows] = 255
    if family == "plateau":
        maps |= np.roll(maps, 1, axis=2)
        maps[::2] |= np.roll(maps[::2], 2, axis=2)
    return maps


def layered_bscans(rng, n: int, h: int, w: int, num_classes: int):
    """``(n, h, w, 1)`` uint8 B-scans: ``num_classes`` layers with smooth
    wiggling boundaries, a grey level per layer, Gaussian noise."""
    rows = np.arange(h)[:, None]
    levels = np.linspace(40, 220, num_classes)
    out = np.empty((n, h, w, 1), np.uint8)
    for i in range(n):
        bounds = []
        for cls in range(1, num_classes):
            base = h * cls / num_classes + rng.integers(-h // 16, h // 16)
            wiggle = np.cumsum(rng.integers(-1, 2, size=w))
            bounds.append(np.clip(base + wiggle - wiggle.mean(), 1, h - 2))
        bounds = np.sort(np.stack(bounds), axis=0)
        labels = (rows[None] >= bounds[:, None, :]).sum(0)
        image = levels[labels] + rng.normal(0, 8.0, size=(h, w))
        out[i, ..., 0] = np.clip(image, 0, 255).astype(np.uint8)
    return out


def phase_environment() -> dict:
    from oct_image_segmentation_models_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}"
    )
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.2f} s: {sorted(logs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return {"card": card, "build_s": build_s}


def phase_kernel_parity(rng) -> dict:
    """The CUDA kernel against the plain version, bit for bit."""
    from oct_image_segmentation_models_torch.ops.minpath import delineate_reference
    from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda

    cases = [
        (family, N_MAPS, W, H, 1, 2) for family in ("ridge", "plateau", "sparse")
    ] + [
        ("ridge", 4, 64, 11, 1, 2),
        ("sparse", 4, 64, 11, 1, 2),
        ("plateau", 4, 256, 500, 1, 2),
        ("ridge", 6, 128, 64, 2, 4),
        ("plateau", 6, 128, 64, 2, 3),
        ("ridge", 1, W, H, 1, 2),
        ("sparse", 25, 128, 64, 1, 2),
    ]
    max_err = 0
    for family, n, w, h, g, step in cases:
        maps = torch.from_numpy(synthetic_maps(rng, family, n, w, h, step)).cuda()
        for tie in ("exact", "fast"):
            got = delineate_cuda(maps, max_grad=g, tie_parity=tie)
            want = delineate_reference(maps, max_grad=g, tie_parity=tie)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            print(
                f"kernel parity {family:7s} N={n:2d} W={w:4d} H={h:3d} g={g} "
                f"{tie:5s}: max |diff| {err}"
            )
            if not torch.equal(got, want):
                raise AssertionError(
                    f"CUDA min-path kernel disagrees with the plain version: "
                    f"{family} N={n} W={w} H={h} g={g} {tie}, "
                    f"{int((got != want).sum())} rows differ"
                )
    return {"max_abs_err": max_err, "cases": len(cases) * 2}


def phase_slice(rng, seed: int) -> dict:
    """The serving path at full width, through the kernel."""
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.boundary import (
        boundary_maps_from_labels,
    )
    from oct_image_segmentation_models_torch.ops.minpath import delineate_reference
    from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda
    from oct_image_segmentation_models_torch.prediction.streaming import (
        VolumeSegmenter,
    )

    container = get_model_class("unet")(
        input_channels=1,
        num_classes=NUM_CLASSES,
        image_height=H,
        image_width=W,
        start_neurons=32,
        pool_layers=4,
        conv_layers=2,
    )
    config = container.get_config()
    module = container.build_model(
        generator=torch.Generator().manual_seed(seed), device="cuda"
    )
    loaded = LoadedModel("unet", module, config)
    seg_fast = VolumeSegmenter(loaded, config, batch_size=BATCH, device="cuda")
    seg_exact = VolumeSegmenter(
        loaded, config, batch_size=BATCH, minpath_tie_parity="exact", device="cuda"
    )
    volume = layered_bscans(rng, VOLUME, H, W, NUM_CLASSES)

    delineate_cuda.launches = 0
    t0 = time.perf_counter()
    labels, rows = seg_fast.segment_volume(volume)
    labels_x, rows_x = seg_exact.segment_volume(volume[:BATCH])
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = delineate_cuda.launches
    print(
        f"main path: {VOLUME} B-scans fast + {BATCH} exact in {first_run_s:.2f} s "
        f"(first call), minpath kernel launches {launches}"
    )
    if launches < 1:
        raise AssertionError("the main path never launched the CUDA min-path kernel")

    m = NUM_CLASSES - 1
    for name, got, want in (
        ("labels", labels.shape, (VOLUME, H, W)),
        ("rows", rows.shape, (VOLUME, m, W)),
        ("exact rows", rows_x.shape, (BATCH, m, W)),
    ):
        if got != want:
            raise AssertionError(f"{name} shape {got}, expected {want}")
    if labels.dtype != np.uint8 or rows.dtype != np.uint16:
        raise AssertionError(f"dtypes {labels.dtype}, {rows.dtype}")
    if labels.max() >= NUM_CLASSES or rows.max() >= H:
        raise AssertionError("labels or rows out of range")

    # Rows against the plain min-path on maps rebuilt from the labels.
    for tie, lab, got in (("fast", labels, rows), ("exact", labels_x, rows_x)):
        maps = boundary_maps_from_labels(torch.from_numpy(lab).cuda(), NUM_CLASSES)
        want = delineate_reference(
            maps.transpose(-1, -2).contiguous(), tie_parity=tie
        )
        if not np.array_equal(got.astype(np.int64), want.cpu().numpy()):
            raise AssertionError(f"{tie}-tie rows differ from the plain min-path")
        print(f"rows ({tie} ties) equal the plain min-path on the returned labels")

    # One B-scan's probabilities: the card's forward against the CPU's.
    folded = fold_batchnorm(module)
    x = torch.from_numpy(volume[:1]).to(torch.float32) / 255.0
    with torch.inference_mode(), float32_precision():
        p_gpu = folded(x.cuda()).cpu()
        p_cpu = copy.deepcopy(folded).cpu()(x)
    if not torch.isfinite(p_gpu).all():
        raise AssertionError("non-finite probabilities on the card")
    prob_err = float((p_gpu - p_cpu).abs().max())
    agree = float((p_gpu.argmax(-1) == p_cpu.argmax(-1)).float().mean())
    print(
        f"probabilities card vs CPU float32: max |diff| {prob_err:.3e} "
        f"(tolerance {PROB_ATOL:g}), argmax agreement {agree:.6f}"
    )
    if prob_err > PROB_ATOL:
        raise AssertionError(f"card forward off the CPU forward by {prob_err}")
    return {
        "launches": launches,
        "prob_max_abs_err": prob_err,
        "argmax_agreement": agree,
        "seg_fast": seg_fast,
        "seg_exact": seg_exact,
        "folded": folded,
        "volume": volume,
    }


def kernel_bound_ms(n: int, w: int, h: int, max_grad: int, exact: bool) -> tuple:
    """Least time for the min-path function on these shapes: bytes (maps
    read once, int32 rows written once) over HBM bandwidth, against int32
    operations (per node and candidate a subtract and a min, plus the
    edge add; exact mode adds a rank, ~log2(H) compares per node) over the
    ALU rate. Returns ``(ms, "bytes" | "operations")``."""
    bytes_moved = n * w * h + 4 * n * w
    ops = n * (w - 1) * h * (2 * (2 * max_grad + 1) + 1)
    if exact:
        ops += n * w * h * max(1, (h - 1).bit_length())
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_flops(module, x) -> int:
    """Multiply-add FLOPs (2 per MAC) of every convolution in one forward
    of ``module`` on ``x``, counted from the layers' output shapes."""
    total = 0

    def hook(conv, _inp, out):
        nonlocal total
        kh, kw = conv.kernel_size
        total += 2 * out.numel() * (conv.in_channels // conv.groups) * kh * kw

    handles = [
        m.register_forward_hook(hook)
        for m in module.modules()
        if isinstance(m, torch.nn.Conv2d)
    ]
    try:
        with torch.inference_mode():
            module(x)
    finally:
        for h in handles:
            h.remove()
    return total


def profile_pipeline(pipe, batch, calls: int = 3) -> dict:
    """Device busy share of the pipeline and its kernels by device time,
    from ``torch.profiler`` over ``calls`` batches after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pipe(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: host-side aten ops also carry their kernels' device
    # time, which would count it twice.
    rows = [
        (e.key, e.self_device_time_total / 1e3 / calls)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    return {
        "profiled_wall_ms_per_batch": wall_ms / calls,
        "device_ms_per_batch": device_ms,
        "device_busy_share": device_ms / (wall_ms / calls) if rows else None,
        "top_kernels_ms_per_batch": rows[:8],
    }


def phase_times(sl: dict) -> dict:
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.ops import boundary as bops
    from oct_image_segmentation_models_torch.ops.minpath import delineate_reference
    from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda

    batch = torch.from_numpy(sl["volume"][:BATCH]).pin_memory()
    out = {}
    for tie in ("fast", "exact"):
        pipe = sl[f"seg_{tie}"]._pipeline
        ms = time_cuda(lambda: pipe(batch), iters=3)
        out[f"pipeline_{tie}_ms"] = ms
        out[f"pipeline_{tie}_bscans_per_s"] = BATCH / ms * 1e3

    seg = sl["seg_fast"]
    t0 = time.perf_counter()
    seg.segment_volume(sl["volume"])
    out["volume_s"] = time.perf_counter() - t0
    out["volume_bscans_per_s"] = VOLUME / out["volume_s"]

    out.update(profile_pipeline(sl["seg_fast"]._pipeline, batch))

    # Stages of one batch.
    x = (batch.cuda().to(torch.float32) / 255.0).contiguous()
    folded = sl["folded"]
    out["forward_gflop_per_batch"] = conv_flops(folded, x) / 1e9
    with torch.inference_mode(), float32_precision():
        out["forward_ms"] = time_cuda(lambda: folded(x), iters=3)
        out["forward_tflops"] = out["forward_gflop_per_batch"] / out["forward_ms"]
        out["forward_bound_ms"] = (
            out["forward_gflop_per_batch"] * 1e9 / FP32_FLOPS_PER_S * 1e3
        )
        probs = folded(x)

        def post():
            _, cat = bops.perform_argmax(probs)
            return bops.boundary_prob_maps(cat)

        out["maps_ms"] = time_cuda(post, iters=5)
        maps_img = post()
        out["transpose_ms"] = time_cuda(
            lambda: maps_img.transpose(-1, -2).contiguous(), iters=5
        )
        maps_t = maps_img.transpose(-1, -2).contiguous()
        for tie in ("fast", "exact"):
            out[f"kernel_{tie}_ms"] = time_cuda(
                lambda: delineate_cuda(maps_t, tie_parity=tie), iters=10
            )
            out[f"plain_{tie}_ms"] = time_cuda(
                lambda: delineate_reference(maps_t, tie_parity=tie),
                iters=1,
                reps=3,
                warmup=1,
            )
            bound, by = kernel_bound_ms(N_MAPS, W, H, 1, tie == "exact")
            out[f"bound_{tie}_ms"] = bound
            out[f"bound_{tie}_by"] = by
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="also write every number to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card", file=sys.stderr)
        return 2

    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    env = phase_environment()
    parity = phase_kernel_parity(rng)
    sl = phase_slice(rng, args.seed)
    times = phase_times(sl)

    card = env["card"]
    for tie in ("fast", "exact"):
        print(
            f"[{card}] pipeline batch {BATCH} x {H}x{W}, {tie} ties: "
            f"{times[f'pipeline_{tie}_ms']:.3f} ms/batch, "
            f"{times[f'pipeline_{tie}_bscans_per_s']:.1f} B-scans/s"
        )
    print(
        f"[{card}] stages (batch {BATCH}): forward {times['forward_ms']:.3f} ms, "
        f"argmax+maps {times['maps_ms']:.3f} ms, transpose "
        f"{times['transpose_ms']:.3f} ms, minpath fast {times['kernel_fast_ms']:.3f}"
        f" ms / exact {times['kernel_exact_ms']:.3f} ms"
    )
    print(
        f"[{card}] forward: {times['forward_gflop_per_batch']:.1f} GFLOP/batch, "
        f"{times['forward_tflops']:.2f} TFLOP/s, float32 bound "
        f"{times['forward_bound_ms']:.3f} ms"
    )
    busy = times["device_busy_share"]
    print(
        f"[{card}] profiled pipeline (fast): wall "
        f"{times['profiled_wall_ms_per_batch']:.3f} ms/batch, device "
        f"{times['device_ms_per_batch']:.3f} ms/batch, busy share "
        + ("not measured" if busy is None else f"{busy:.4f}")
    )
    for name, ms in times["top_kernels_ms_per_batch"]:
        print(f"  {ms:9.3f} ms/batch  {name[:100]}")
    print(
        f"[{card}] volume of {VOLUME} B-scans: {times['volume_s']:.3f} s, "
        f"{times['volume_bscans_per_s']:.1f} B-scans/s"
    )
    for tie in ("fast", "exact"):
        print(
            f"[{card}] minpath_dp {tie} at {N_MAPS}x{W}x{H}: kernel "
            f"{times[f'kernel_{tie}_ms']:.4f} ms, plain "
            f"{times[f'plain_{tie}_ms']:.1f} ms, bound "
            f"{times[f'bound_{tie}_ms']:.5f} ms ({times[f'bound_{tie}_by']})"
        )
    kernels = [
        {
            "name": "minpath_dp",
            "route": "cuda",
            "source": "oct_image_segmentation_models_torch/csrc/minpath.cu",
            "replaces": "oct_image_segmentation_models_tpu/ops/minpath_pallas.py:487",
            "launches": sl["launches"],
            "max_abs_err": parity["max_abs_err"],
            "ms": times["kernel_fast_ms"],
            "plain_ms": times["plain_fast_ms"],
            "bound_ms": times["bound_fast_ms"],
            "bound_by": times["bound_fast_by"],
            "library_ms": None,
            "ms_exact": times["kernel_exact_ms"],
            "plain_ms_exact": times["plain_exact_ms"],
            "bound_ms_exact": times["bound_exact_ms"],
            "bound_by_exact": times["bound_exact_by"],
        }
    ]
    if args.out:
        record = {
            "card": card,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "seed": args.seed,
            "build_s": env["build_s"],
            "parity_cases": parity["cases"],
            "prob_max_abs_err": sl["prob_max_abs_err"],
            "argmax_agreement": sl["argmax_agreement"],
            "times": times,
            "kernels": kernels,
            "total_s": time.perf_counter() - t_start,
        }
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
