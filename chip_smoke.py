#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which raises on failure:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel in
   ``oct_image_segmentation_models_torch/csrc`` (one ``nvcc`` per source,
   all started together).
2. Kernel parity, each kernel against its plain PyTorch version on the
   same CUDA tensors:
   - ``minpath_dp`` (B1), bit for bit, both tie modes, at the flagship
     shape (24 maps x 1024 columns x 512 rows) and at odd ones;
   - ``minpath_dp_s2d`` (B2) on s2d maps, bit for bit against its plain
     version and against B1 on the transposed maps, both tie modes, at
     (8, 3, 256, 512, 4) and at odd ones;
   - ``s2d_enc_pair`` (B3) within ``PAIR_ATOL`` at the flagship level-1
     shape and two small ones; ``pooled`` exactly the phase max of ``y2``.
3. The paths at full width, on the bench's U-Net (start_neurons=32,
   pool_layers=4, conv_layers=2, 4 classes, 512x1024 B-scans, batch 8,
   random weights from a seeded ``torch.Generator``), each driven with the
   launch counts set to 0 just before it and read just after:
   - the s2d serving path (the main path): ``VolumeSegmenter`` with its
     defaults segments a 20-B-scan volume with fast ties and one batch with
     exact ties through B2; its rows must equal the plain min-path on maps
     rebuilt from the returned labels, and one B-scan's labels must agree
     with the CPU s2d forward;
   - the BN-folded path of the first slice, through B1, checked the same
     way, with one B-scan's probabilities against the CPU forward;
   - the s2d forward with fused encoder pairs, one batch through B3.
4. Times, with CUDA events (median of several runs after warm-up): both
   pipelines per batch and their stages, each kernel per call beside its
   plain version, its yardstick and its bound.

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
# The encoder-pair kernel against the unfused cuDNN chain: float32 sums of
# depth up to 4 * 4C = 1024 at O(1) activations, in another order (the JAX
# kernel test's figure).
PAIR_ATOL = 1e-4
# Argmax agreement between two float32 forwards that differ only in
# summation order: a near-zero-margin pixel can flip.
MIN_AGREEMENT = 0.999


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


def phase_s2d_kernel_parity(rng) -> dict:
    """The s2d min-path kernel against its plain version and against the
    (W, H) kernel on the transposed maps, bit for bit."""
    from oct_image_segmentation_models_torch.ops.boundary import (
        image_maps_to_s2d,
        s2d_maps_to_transposed,
    )
    from oct_image_segmentation_models_torch.ops.minpath import (
        delineate_s2d_reference,
    )
    from oct_image_segmentation_models_torch.ops.minpath_cuda import (
        delineate_cuda,
        delineate_cuda_s2d,
    )

    m = NUM_CLASSES - 1
    cases = [(family, BATCH, m, W, H, 1, 2) for family in ("ridge", "plateau", "sparse")]
    cases += [
        ("plateau", 2, 2, 256, 500, 1, 2),  # Hb = 250, not a power of two
        ("ridge", 2, 3, 128, 64, 2, 4),
        ("plateau", 2, 3, 128, 64, 2, 3),
        ("ridge", 1, 1, W, H, 1, 2),
        ("sparse", 25, 1, 128, 64, 1, 2),
    ]
    max_err = 0
    for family, b, mm, w, h, g, step in cases:
        maps_t = torch.from_numpy(synthetic_maps(rng, family, b * mm, w, h, step)).cuda()
        s2d = image_maps_to_s2d(maps_t.transpose(-1, -2).reshape(b, mm, h, w))
        for tie in ("exact", "fast"):
            got = delineate_cuda_s2d(s2d, max_grad=g, tie_parity=tie)
            want = delineate_s2d_reference(s2d, max_grad=g, tie_parity=tie)
            b1 = delineate_cuda(
                s2d_maps_to_transposed(s2d).contiguous(), max_grad=g, tie_parity=tie
            )
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            print(
                f"s2d kernel parity {family:7s} B={b:2d} M={mm} W={w:4d} H={h:3d} "
                f"g={g} {tie:5s}: max |diff| {err}, vs B1 "
                f"{int((got - b1).abs().max())}"
            )
            if not (torch.equal(got, want) and torch.equal(got, b1)):
                raise AssertionError(
                    f"s2d min-path kernel disagrees: {family} B={b} M={mm} W={w} "
                    f"H={h} g={g} {tie}, {int((got != want).sum())} rows differ "
                    f"from the plain version, {int((got != b1).sum())} from B1"
                )
    return {"max_abs_err": max_err, "cases": len(cases) * 2}


def enc_pair_inputs(rng, b, nh, nw, cin4, c4):
    """Encoder-pair operands on the card: x ~ N(0, 1), weights scaled by
    1/sqrt(fan_in) so the activations stay O(1)."""

    def t(*shape, fan_in=1):
        a = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        return torch.from_numpy(a).cuda()

    return (
        t(b, nh, nw, cin4),
        t(2, 2, cin4, c4, fan_in=4 * cin4),
        t(c4),
        t(2, 2, c4, c4, fan_in=4 * c4),
        t(c4),
    )


def phase_enc_pair_parity(rng) -> dict:
    """The encoder-pair kernel against the unfused chain (cuDNN, TF32 off)."""
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.ops.s2d_enc_pair import (
        fused_enc_pair_reference,
    )
    from oct_image_segmentation_models_torch.ops.s2d_enc_pair_cuda import (
        fused_enc_pair_cuda,
    )
    from oct_image_segmentation_models_torch.ops.s2d_unet import phase_max_pool

    cases = [
        (BATCH, H // 4, W // 4, 128, 256),  # flagship level 1
        (2, 6, 16, 128, 128),  # nh = 6: the gate's tr = 2
        (2, 8, 12, 8, 64),  # 4Cin = 8, 4C = 64, called directly
    ]
    max_err = 0.0
    flagship = None
    for shape in cases:
        args = enc_pair_inputs(rng, *shape)
        y2, pooled = fused_enc_pair_cuda(*args)
        with float32_precision():
            want_y2, want_pool = fused_enc_pair_reference(*args)
        torch.cuda.synchronize()
        err = float((y2 - want_y2).abs().max())
        pool_err = float((pooled - want_pool).abs().max())
        exact_pool = torch.equal(pooled, phase_max_pool(y2))
        max_err = max(max_err, err, pool_err)
        print(
            f"enc pair parity B={shape[0]} nh={shape[1]} nw={shape[2]} "
            f"4Cin={shape[3]} 4C={shape[4]}: y2 max |diff| {err:.3e}, pooled "
            f"{pool_err:.3e} (tolerance {PAIR_ATOL:g}); pooled == phase max of "
            f"y2: {exact_pool}; |y2| max {float(want_y2.abs().max()):.3f}"
        )
        if not torch.isfinite(y2).all() or err > PAIR_ATOL or pool_err > PAIR_ATOL:
            raise AssertionError(f"encoder-pair kernel off its plain version: {shape}")
        if not exact_pool:
            raise AssertionError("pooled is not the phase max of the kernel's y2")
        if flagship is None:
            flagship = args
    return {"max_abs_err": max_err, "flagship_args": flagship}


def build_unet(seed: int):
    from oct_image_segmentation_models_torch.models import get_model_class

    container = get_model_class("unet")(
        input_channels=1,
        num_classes=NUM_CLASSES,
        image_height=H,
        image_width=W,
        start_neurons=32,
        pool_layers=4,
        conv_layers=2,
    )
    module = container.build_model(
        generator=torch.Generator().manual_seed(seed), device="cuda"
    )
    return container, module


def kernel_counts() -> dict:
    from oct_image_segmentation_models_torch.ops.minpath_cuda import (
        delineate_cuda,
        delineate_cuda_s2d,
    )
    from oct_image_segmentation_models_torch.ops.s2d_enc_pair_cuda import (
        fused_enc_pair_cuda,
    )

    return {
        "minpath_dp": delineate_cuda,
        "minpath_dp_s2d": delineate_cuda_s2d,
        "s2d_enc_pair": fused_enc_pair_cuda,
    }


def reset_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counts().items()}


def check_rows(tie: str, labels: np.ndarray, rows: np.ndarray) -> None:
    """Served rows against the plain min-path on maps rebuilt from the
    served labels."""
    from oct_image_segmentation_models_torch.ops.boundary import (
        boundary_maps_from_labels,
    )
    from oct_image_segmentation_models_torch.ops.minpath import delineate_reference

    n = labels.shape[0]
    m = NUM_CLASSES - 1
    if labels.shape != (n, H, W) or rows.shape != (n, m, W):
        raise AssertionError(f"shapes {labels.shape}, {rows.shape}")
    if labels.dtype != np.uint8 or rows.dtype != np.uint16:
        raise AssertionError(f"dtypes {labels.dtype}, {rows.dtype}")
    if labels.max() >= NUM_CLASSES or rows.max() >= H:
        raise AssertionError("labels or rows out of range")
    maps = boundary_maps_from_labels(torch.from_numpy(labels).cuda(), NUM_CLASSES)
    want = delineate_reference(maps.transpose(-1, -2).contiguous(), tie_parity=tie)
    if not np.array_equal(rows.astype(np.int64), want.cpu().numpy()):
        raise AssertionError(f"{tie}-tie rows differ from the plain min-path")
    print(f"rows ({tie} ties, {n} B-scans) equal the plain min-path on the returned labels")


def run_volume(pipe, volume: np.ndarray):
    """A volume through a pipeline in batches of ``BATCH``, as
    ``VolumeSegmenter`` batches it -> numpy (labels, rows)."""
    n = volume.shape[0]
    pad = (-n) % BATCH
    if pad:
        volume = np.concatenate([volume, volume[-1:].repeat(pad, 0)])
    labels, rows = [], []
    for i in range(0, len(volume), BATCH):
        lab, _, r = pipe(torch.from_numpy(volume[i : i + BATCH]).pin_memory())
        labels.append(lab)
        rows.append(r)
    return torch.cat(labels).cpu().numpy()[:n], torch.cat(rows).cpu().numpy()[:n]


def phase_s2d_slice(model, volume: np.ndarray) -> dict:
    """The main path: VolumeSegmenter's defaults, the s2d forward, B2."""
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.ops.s2d_unet import build_s2d_apply
    from oct_image_segmentation_models_torch.prediction.streaming import (
        VolumeSegmenter,
    )

    container, module = model
    config = container.get_config()
    loaded = LoadedModel("unet", module, config)
    seg_fast = VolumeSegmenter(loaded, config, batch_size=BATCH, device="cuda")
    seg_exact = VolumeSegmenter(
        loaded, config, batch_size=BATCH, minpath_tie_parity="exact", device="cuda"
    )
    if (seg_fast.kind, seg_exact.kind) != ("s2d", "s2d"):
        raise AssertionError(f"VolumeSegmenter chose {seg_fast.kind}, not s2d")

    reset_counts()
    t0 = time.perf_counter()
    labels, rows = seg_fast.segment_volume(volume)
    labels_x, rows_x = seg_exact.segment_volume(volume[:BATCH])
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    counts = read_counts()
    print(
        f"s2d path (kind {seg_fast.kind}): {VOLUME} B-scans fast + {BATCH} exact in "
        f"{first_run_s:.2f} s (first call), launches {counts}"
    )
    if counts["minpath_dp_s2d"] < 1:
        raise AssertionError("the s2d path never launched the s2d min-path kernel")
    if counts["minpath_dp"] or counts["s2d_enc_pair"]:
        raise AssertionError(f"the s2d path launched other kernels: {counts}")
    check_rows("fast", labels, rows)
    check_rows("exact", labels_x, rows_x)

    # One B-scan's served labels against the CPU s2d forward.
    cpu_fwd = build_s2d_apply(copy.deepcopy(module).cpu(), output="labels")
    x = torch.from_numpy(volume[:1]).to(torch.float32) / 255.0
    with torch.inference_mode(), float32_precision():
        lab_cpu = cpu_fwd(x).numpy()
    agree = float((labels[:1] == lab_cpu).mean())
    print(f"s2d labels card vs CPU s2d forward, one B-scan: agreement {agree:.6f}")
    if agree < MIN_AGREEMENT:
        raise AssertionError(f"s2d labels agree with the CPU forward on {agree}")
    return {
        "launches": counts["minpath_dp_s2d"],
        "agreement_cpu": agree,
        "labels": labels,
        "seg_fast": seg_fast,
        "seg_exact": seg_exact,
    }


def phase_folded(model, volume: np.ndarray) -> dict:
    """The first slice's path: the BN-folded forward, B1."""
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline

    container, module = model
    folded = fold_batchnorm(module)
    pipes = {
        tie: make_fused_pipeline(
            folded,
            container.get_preprocess_input_fn(),
            minpath_tie_parity=tie,
            return_maps=False,
            device="cuda",
        )
        for tie in ("fast", "exact")
    }
    reset_counts()
    labels, rows = run_volume(pipes["fast"], volume)
    labels_x, rows_x = run_volume(pipes["exact"], volume[:BATCH])
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"folded path: {VOLUME} B-scans fast + {BATCH} exact, launches {counts}")
    if counts["minpath_dp"] < 1:
        raise AssertionError("the folded path never launched the CUDA min-path kernel")
    if counts["minpath_dp_s2d"] or counts["s2d_enc_pair"]:
        raise AssertionError(f"the folded path launched other kernels: {counts}")
    check_rows("fast", labels, rows)
    check_rows("exact", labels_x, rows_x)

    # One B-scan's probabilities: the card's forward against the CPU's.
    x = torch.from_numpy(volume[:1]).to(torch.float32) / 255.0
    with torch.inference_mode(), float32_precision():
        p_gpu = folded(x.cuda()).cpu()
        p_cpu = copy.deepcopy(folded).cpu()(x)
    if not torch.isfinite(p_gpu).all():
        raise AssertionError("non-finite probabilities on the card")
    prob_err = float((p_gpu - p_cpu).abs().max())
    agree = float((p_gpu.argmax(-1) == p_cpu.argmax(-1)).float().mean())
    print(
        f"folded probabilities card vs CPU float32: max |diff| {prob_err:.3e} "
        f"(tolerance {PROB_ATOL:g}), argmax agreement {agree:.6f}"
    )
    if prob_err > PROB_ATOL:
        raise AssertionError(f"card forward off the CPU forward by {prob_err}")
    return {
        "launches": counts["minpath_dp"],
        "prob_max_abs_err": prob_err,
        "argmax_agreement": agree,
        "labels": labels,
        "pipes": pipes,
        "folded": folded,
    }


def phase_fused(model, volume: np.ndarray, s2d_labels: np.ndarray) -> dict:
    """One batch through the s2d forward with fused encoder pairs (B3)."""
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.ops.s2d_unet import build_s2d_apply

    container, module = model
    labels_fn = build_s2d_apply(module, output="labels_s2d", fuse_enc_pairs=True)
    pipe = make_fused_pipeline(
        None,
        container.get_preprocess_input_fn(),
        minpath_tie_parity="fast",
        labels_apply_fn=labels_fn,
        num_classes=NUM_CLASSES,
        return_maps=False,
        device="cuda",
    )
    batch = torch.from_numpy(volume[:BATCH]).pin_memory()
    reset_counts()
    labels, _, rows = pipe(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"fused-pair path: one batch, launches {counts}")
    if counts["s2d_enc_pair"] != 1 or counts["minpath_dp_s2d"] != 1:
        raise AssertionError(f"expected one B3 and one B2 launch per batch: {counts}")
    agree = float((labels.cpu().numpy() == s2d_labels[:BATCH]).mean())
    print(f"fused-pair labels vs the unfused s2d forward: agreement {agree:.6f}")
    if agree < MIN_AGREEMENT:
        raise AssertionError(f"fused-pair labels agree with the unfused on {agree}")
    check_rows("fast", labels.cpu().numpy(), rows.cpu().numpy())
    return {
        "launches": counts["s2d_enc_pair"],
        "agreement_unfused": agree,
        "labels_fn": labels_fn,
        "pipe": pipe,
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


def enc_pair_bound_ms(b, nh, nw, cin4, c4) -> tuple:
    """Least time for the encoder pair on these shapes: the dense
    block-space FLOPs (2 per multiply-add, both convs, y1 with its
    (nh+1, nw+1) shifted grid) over the float32 rate, against the bytes of
    x, the weights and biases read once and y2 and pooled written once over
    HBM bandwidth. Returns ``(ms, "bytes" | "operations", flop)``."""
    flop = 2 * b * (
        (nh + 1) * (nw + 1) * 4 * cin4 * c4 + nh * nw * 4 * c4 * c4
    )
    bytes_moved = 4 * (
        b * nh * nw * cin4
        + 4 * cin4 * c4
        + 4 * c4 * c4
        + 2 * c4
        + b * nh * nw * c4
        + b * nh * nw * c4 // 4
    )
    t_ops = flop / FP32_FLOPS_PER_S * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", flop
    return t_ops, "operations", flop


def forward_flop(fn, x) -> int:
    """FLOPs (2 per multiply-add) of the convolutions in one call of ``fn``
    on ``x``, counted by ``torch.utils.flop_counter`` from the shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        fn(x)
    return counter.get_total_flops()


def phase_times(model, s2d: dict, folded: dict, fused: dict, pair_args) -> dict:
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.ops import boundary as bops
    from oct_image_segmentation_models_torch.ops.minpath import (
        delineate_reference,
        delineate_s2d_reference,
    )
    from oct_image_segmentation_models_torch.ops.minpath_cuda import (
        delineate_cuda,
        delineate_cuda_s2d,
    )
    from oct_image_segmentation_models_torch.ops.s2d_enc_pair import (
        fused_enc_pair_reference,
    )
    from oct_image_segmentation_models_torch.ops.s2d_enc_pair_cuda import (
        fused_enc_pair_cuda,
    )
    from oct_image_segmentation_models_torch.ops.s2d_unet import build_s2d_apply, d2s

    _, module = model
    volume = s2d["volume"]
    batch = torch.from_numpy(volume[:BATCH]).pin_memory()
    out = {}
    pipes = {
        "s2d": {t: s2d[f"seg_{t}"]._pipeline for t in ("fast", "exact")},
        "folded": folded["pipes"],
    }
    for path, by_tie in pipes.items():
        for tie, pipe in by_tie.items():
            ms = time_cuda(lambda: pipe(batch), iters=3)
            out[f"{path}_pipeline_{tie}_ms"] = ms
            out[f"{path}_pipeline_{tie}_bscans_per_s"] = BATCH / ms * 1e3

    t0 = time.perf_counter()
    s2d["seg_fast"].segment_volume(volume)
    out["volume_s"] = time.perf_counter() - t0
    out["volume_bscans_per_s"] = VOLUME / out["volume_s"]

    for path in ("s2d", "folded"):
        for key, value in profile_pipeline(pipes[path]["fast"], batch).items():
            out[f"{path}_{key}"] = value

    x = (batch.cuda().to(torch.float32) / 255.0).contiguous()
    s2d_fwd = build_s2d_apply(module, output="labels_s2d")
    fused_fwd = fused["labels_fn"]
    fold_fwd = folded["folded"]
    with torch.inference_mode(), float32_precision():
        # s2d stages.
        out["s2d_forward_gflop"] = forward_flop(s2d_fwd, x) / 1e9
        out["s2d_forward_ms"] = time_cuda(lambda: s2d_fwd(x), iters=3)
        out["s2d_fused_forward_ms"] = time_cuda(lambda: fused_fwd(x), iters=3)
        lab_s2d = s2d_fwd(x)

        def s2d_maps():
            d2s(lab_s2d)[..., 0]
            return bops.boundary_maps_from_s2d_labels(
                lab_s2d, NUM_CLASSES, transposed="s2d"
            )

        out["s2d_maps_ms"] = time_cuda(s2d_maps, iters=5)
        maps_s2d = s2d_maps()
        # Folded stages (the first slice's).
        out["folded_forward_gflop"] = forward_flop(fold_fwd, x) / 1e9
        out["folded_forward_ms"] = time_cuda(lambda: fold_fwd(x), iters=3)
        probs = fold_fwd(x)

        def folded_maps():
            _, cat = bops.perform_argmax(probs)
            return bops.boundary_prob_maps(cat)

        out["folded_maps_ms"] = time_cuda(folded_maps, iters=5)
        maps_img = folded_maps()
        out["folded_transpose_ms"] = time_cuda(
            lambda: maps_img.transpose(-1, -2).contiguous(), iters=5
        )
        maps_t = maps_img.transpose(-1, -2).contiguous()
        for path in ("s2d", "folded"):
            gflop = out[f"{path}_forward_gflop"]
            out[f"{path}_forward_tflops"] = gflop / out[f"{path}_forward_ms"]
            out[f"{path}_forward_bound_ms"] = gflop * 1e9 / FP32_FLOPS_PER_S * 1e3

        n_maps, w = maps_t.shape[0] * maps_t.shape[1], maps_t.shape[2]
        for tie in ("fast", "exact"):
            bound, by = kernel_bound_ms(n_maps, w, H, 1, tie == "exact")
            # B1 on the folded path's maps.
            out[f"b1_{tie}_ms"] = time_cuda(
                lambda: delineate_cuda(maps_t, tie_parity=tie), iters=10
            )
            out[f"b1_plain_{tie}_ms"] = time_cuda(
                lambda: delineate_reference(maps_t, tie_parity=tie),
                iters=1, reps=3, warmup=1,
            )
            # B2 on the s2d path's maps, and its yardstick: transpose + B1.
            out[f"b2_{tie}_ms"] = time_cuda(
                lambda: delineate_cuda_s2d(maps_s2d, tie_parity=tie), iters=10
            )
            out[f"b2_yardstick_{tie}_ms"] = time_cuda(
                lambda: delineate_cuda(
                    bops.s2d_maps_to_transposed(maps_s2d).contiguous(), tie_parity=tie
                ),
                iters=10,
            )
            out[f"b2_plain_{tie}_ms"] = time_cuda(
                lambda: delineate_s2d_reference(maps_s2d, tie_parity=tie),
                iters=1, reps=3, warmup=1,
            )
            out[f"minpath_bound_{tie}_ms"] = bound
            out[f"minpath_bound_{tie}_by"] = by

        # B3 at the flagship level-1 shape.
        shape = tuple(pair_args[0].shape) + (pair_args[1].shape[-1],)
        out["b3_ms"] = time_cuda(lambda: fused_enc_pair_cuda(*pair_args), iters=5)
        # The plain version is the unfused cuDNN chain of the s2d forward,
        # so this one time is both the plain and the library yardstick.
        out["b3_plain_ms"] = time_cuda(
            lambda: fused_enc_pair_reference(*pair_args), iters=3
        )
        out["b3_shape"] = shape
        bound, by, flop = enc_pair_bound_ms(*shape)
        out["b3_bound_ms"], out["b3_bound_by"] = bound, by
        out["b3_tflops"] = flop / 1e9 / out["b3_ms"]
    return out


def kernel_line(name, source, replaces, launches, max_err, ms, plain, bound, by, lib):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib,
    }


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
    parity_s2d = phase_s2d_kernel_parity(rng)
    parity_pair = phase_enc_pair_parity(rng)
    model = build_unet(args.seed)
    volume = layered_bscans(rng, VOLUME, H, W, NUM_CLASSES)
    s2d = phase_s2d_slice(model, volume)
    s2d["volume"] = volume
    folded = phase_folded(model, volume)
    agree_folded = float((s2d["labels"] == folded["labels"]).mean())
    print(f"s2d labels vs folded labels, {VOLUME} B-scans: agreement {agree_folded:.6f}")
    fused = phase_fused(model, volume, s2d["labels"])
    times = phase_times(model, s2d, folded, fused, parity_pair["flagship_args"])

    card = env["card"]
    for path in ("s2d", "folded"):
        for tie in ("fast", "exact"):
            print(
                f"[{card}] {path} pipeline batch {BATCH} x {H}x{W}, {tie} ties: "
                f"{times[f'{path}_pipeline_{tie}_ms']:.3f} ms/batch, "
                f"{times[f'{path}_pipeline_{tie}_bscans_per_s']:.1f} B-scans/s"
            )
    print(
        f"[{card}] s2d stages (batch {BATCH}): forward {times['s2d_forward_ms']:.3f} ms "
        f"({times['s2d_forward_gflop']:.1f} GFLOP, {times['s2d_forward_tflops']:.2f} "
        f"TFLOP/s, float32 bound {times['s2d_forward_bound_ms']:.3f} ms), with B3 "
        f"{times['s2d_fused_forward_ms']:.3f} ms, labels+maps "
        f"{times['s2d_maps_ms']:.3f} ms, B2 fast {times['b2_fast_ms']:.3f} ms / "
        f"exact {times['b2_exact_ms']:.3f} ms"
    )
    print(
        f"[{card}] folded stages (batch {BATCH}): forward "
        f"{times['folded_forward_ms']:.3f} ms ({times['folded_forward_gflop']:.1f} "
        f"GFLOP, {times['folded_forward_tflops']:.2f} TFLOP/s, float32 bound "
        f"{times['folded_forward_bound_ms']:.3f} ms), argmax+maps "
        f"{times['folded_maps_ms']:.3f} ms, transpose "
        f"{times['folded_transpose_ms']:.3f} ms, B1 fast {times['b1_fast_ms']:.3f} ms"
        f" / exact {times['b1_exact_ms']:.3f} ms"
    )
    for path in ("s2d", "folded"):
        busy = times[f"{path}_device_busy_share"]
        print(
            f"[{card}] profiled {path} pipeline (fast): wall "
            f"{times[f'{path}_profiled_wall_ms_per_batch']:.3f} ms/batch, device "
            f"{times[f'{path}_device_ms_per_batch']:.3f} ms/batch, busy share "
            + ("not measured" if busy is None else f"{busy:.4f}")
        )
        for name, ms in times[f"{path}_top_kernels_ms_per_batch"]:
            print(f"  {ms:9.3f} ms/batch  {name[:100]}")
    print(
        f"[{card}] volume of {VOLUME} B-scans (s2d path): {times['volume_s']:.3f} s, "
        f"{times['volume_bscans_per_s']:.1f} B-scans/s"
    )
    for tie in ("fast", "exact"):
        print(
            f"[{card}] minpath {tie} at {N_MAPS}x{W}x{H}: B1 "
            f"{times[f'b1_{tie}_ms']:.4f} ms (plain {times[f'b1_plain_{tie}_ms']:.1f}"
            f" ms), B2 {times[f'b2_{tie}_ms']:.4f} ms (plain "
            f"{times[f'b2_plain_{tie}_ms']:.1f} ms, transpose + B1 "
            f"{times[f'b2_yardstick_{tie}_ms']:.4f} ms), bound "
            f"{times[f'minpath_bound_{tie}_ms']:.5f} ms "
            f"({times[f'minpath_bound_{tie}_by']})"
        )
    print(
        f"[{card}] s2d_enc_pair at x {times['b3_shape'][:4]}, 4C "
        f"{times['b3_shape'][4]}: kernel "
        f"{times['b3_ms']:.3f} ms ({times['b3_tflops']:.2f} TFLOP/s), plain "
        f"version (the unfused cuDNN chain) {times['b3_plain_ms']:.3f} ms, bound "
        f"{times['b3_bound_ms']:.3f} ms ({times['b3_bound_by']})"
    )
    minpath_src = "oct_image_segmentation_models_torch/csrc/minpath.cu"
    tpu_minpath = "oct_image_segmentation_models_tpu/ops/minpath_pallas.py"
    kernels = []
    for name, launches, err, key, replaces in (
        ("minpath_dp", folded["launches"], parity["max_abs_err"], "b1", f"{tpu_minpath}:487"),
        ("minpath_dp_s2d", s2d["launches"], parity_s2d["max_abs_err"], "b2", f"{tpu_minpath}:533"),
    ):
        line = kernel_line(
            name, minpath_src, replaces, launches, err,
            times[f"{key}_fast_ms"], times[f"{key}_plain_fast_ms"],
            times["minpath_bound_fast_ms"], times["minpath_bound_fast_by"], None,
        )
        line.update(
            ms_exact=times[f"{key}_exact_ms"],
            plain_ms_exact=times[f"{key}_plain_exact_ms"],
            bound_ms_exact=times["minpath_bound_exact_ms"],
            bound_by_exact=times["minpath_bound_exact_by"],
        )
        if key == "b2":
            line["transpose_then_b1_ms"] = times["b2_yardstick_fast_ms"]
            line["transpose_then_b1_ms_exact"] = times["b2_yardstick_exact_ms"]
        kernels.append(line)
    kernels.append(
        kernel_line(
            "s2d_enc_pair",
            "oct_image_segmentation_models_torch/csrc/s2d_enc_pair.cu",
            "oct_image_segmentation_models_tpu/ops/s2d_pallas.py:153",
            fused["launches"], parity_pair["max_abs_err"], times["b3_ms"],
            times["b3_plain_ms"], times["b3_bound_ms"], times["b3_bound_by"],
            times["b3_plain_ms"],
        )
    )
    if args.out:
        record = {
            "card": card,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "seed": args.seed,
            "build_s": env["build_s"],
            "parity_cases": {"b1": parity["cases"], "b2": parity_s2d["cases"]},
            "prob_max_abs_err": folded["prob_max_abs_err"],
            "folded_argmax_agreement_cpu": folded["argmax_agreement"],
            "s2d_agreement_cpu": s2d["agreement_cpu"],
            "s2d_vs_folded_agreement": agree_folded,
            "fused_vs_unfused_agreement": fused["agreement_unfused"],
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
