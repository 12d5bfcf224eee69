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
     shape (24 maps x 1024 columns x 512 rows) and at odd ones: tie-heavy
     maps (constant maps, wide 255 plateaus), H = 1024, H not a power of
     two, max_grad 2, and both choice stores of the kernel (bit planes in
     shared memory, the device scratch), each hit at least once;
   - ``minpath_dp_s2d`` (B2) on s2d maps, bit for bit against its plain
     version and against B1 on the transposed maps, both tie modes, at
     (8, 3, 256, 512, 4) and at odd ones, the same variants included;
   - ``s2d_enc_pair`` (B3) within ``PAIR_ATOL`` at the flagship level-1
     shape, a ragged tile, 4C = 512 and two small ones; ``pooled`` exactly
     the phase max of ``y2``.
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
   - the s2d forward with fused encoder pairs, one batch through B3;
   - the predict path, the device part of the predict and evaluate
     workflows: ``run_pipeline`` (``StagedPipeline``: s2d probabilities,
     image-layout maps, B1) on the 20 B-scans and 4 more at 512x768 in
     one call (two shape buckets), in both tie modes. Its rows must equal
     the plain min-path on the maps it returned, its masks
     ``create_area_mask`` of its rows, its labels the s2d path's on
     >= 0.999 of pixels. Then ``graph_search.segment_maps`` on one batch's
     uint8 maps (one B1 launch, the exact-tie rows again) and
     ``delineate_float`` on the card against the CPU, rows equal;
   - the train path, the device part of ``train_model``: first one train
     step at batch 2 of 128x256 on the card and on the CPU from the same
     weights, batch and dropout mask (loss and BN statistics within stated
     tolerances; per-tensor gradients against the CPU float64 step that
     replays the card step's ReLU gates and max-pool picks); then, from
     fresh weights, the
     port's ``DataGenerator`` feeds ``train_step`` (focal + Dice, Adam 1e-3,
     float32) for 120 steps at batch 8 of 512x1024, ``eval_step`` runs on a
     validation batch and ``BNRefresher`` recomputes the statistics. The
     loss must fall below the first step's and the statistics be finite
     with var > 0. The trained weights are then served through the folded
     path (B1) and the s2d path (B2) on held-out B-scans, rows against the
     plain min-path, and their dice printed;
   - the data-parallel path (``parallel/``), after ``torch.cuda.empty_cache()``:
     first a world of one over NCCL in this process, which runs the
     per-replica step (``impl="shard_map"``, DDP) at full width for 3 Adam
     steps at batch 8 of 512x1024 against the one-device step from the same
     weights, batches and dropout generator, both under deterministic
     algorithms (parameters, running statistics and losses bit for bit),
     and times both steps in turns with the default algorithms (the cost
     of DDP's hooks at world 1);
     then two ranks that share the card over gloo (NCCL refuses two ranks
     on one device), spawned with the ``spawn`` method and joined with a
     time limit. They take one step from common weights at a local batch
     of 4, held against the per-replica definition computed here (the mean
     of the one-device steps' gradients, running statistics, loss and
     metric on the two halves); run the cross-rank ``BNRefresher``, held
     against the one-process refresher over both ranks' batches; and serve
     the 20-B-scan volume through ``VolumeSegmenter(mesh=)`` (s2d, B2) and
     the folded ``make_fused_pipeline(mesh=)`` (B1) in both tie modes, the
     gathered labels and rows equal on every rank to the one-rank paths
     at the ranks' per-call batch of 4, bit for bit. Each rank counts its
     own kernel launches.
   - the DeepLabV3+ path (``deeplab_path``), run before the data-parallel
     path, on DeepLabV3+ (the ResNet50 backbone to conv4, DSPP, decoder,
     4 classes) with seeded random weights and the gray B-scans repeated
     over 3 channels: the eval-mode forward, plain and BN-folded, on the
     card against the CPU at 2 x 128x256 (``PROB_ATOL``, argmax agreement);
     the 20-B-scan volume at 512x1024 through the folded
     ``make_fused_pipeline`` and ``VolumeSegmenter`` in both tie modes,
     rows against the plain min-path, B1 launched and B2 and B3 not; one
     train step at batch 2 of 64x128 on the card and on the CPU, each
     step's gradients against the CPU float64 step that replays its ReLU
     gates and max-pool picks (the card held to the larger of
     ``STEP_GRAD_RTOL`` and ``DL_GRAD_CPU_FACTOR`` times the CPU float32
     step's own error, per tensor); 30 train steps at batch 8 of 512x1024
     from the ``DataGenerator`` (the loss must fall), the eval step,
     ``BNRefresher``, and the trained weights served through B1. Its
     serving times, FLOPs and profile and its train step's split and peak
     memory are printed with the others.
   - the export path (``export_path``), run after the DeepLabV3+ path,
     the deployment surface from files with no h5py: the bench's U-Net
     and the full-width DeepLabV3+ saved as directory checkpoints
     (``save_model_dir``), exported by ``python -m
     oct_image_segmentation_models_torch.cli export ... --height 512
     --width 1024 --dynamic-batch --platforms cuda`` in four subprocesses
     started together, each timed: the optimized U-Net (s2d)
     in both tie modes, a ``--no-optimize`` U-Net and the folded DeepLabV3+
     with fast ties. Each artifact is loaded with
     ``load_exported_pipeline`` and serves the 20-B-scan volume in batches
     of 8, 8 and 4: through ``torch.ops.octseg.minpath_delineate_s2d``
     (B2) for the s2d artifacts and ``minpath_delineate`` (B1) for the
     others, the other kernel never launched; rows against the plain
     min-path on the artifact's labels; labels, maps and rows equal bit
     for bit to eager ``make_fused_pipeline`` with the same forward and
     weights. Its ms per batch of 8 and the eager pipeline's
     (``DeviceStopwatch``, median of 5), the export and load seconds.
4. Times, with CUDA events (median of several runs after warm-up): both
   pipelines per batch and their stages, each kernel per call beside its
   plain version, its yardstick and its bound (B3: on the tensor cores,
   the route it takes, and on the float32 CUDA cores), the min-path per
   column; the predict path's per-image stage times (host clock around
   each synchronised stage, as ``run_pipeline`` keeps them), the host
   copy of one batch's outputs, and ``delineate_float``; the train step
   (ms, B-scans/s, GFLOP and TFLOP/s, its split into forward with loss,
   backward and optimizer, peak memory), the eval step, one
   ``BNRefresher`` pass, and the training loop with its host batches.

Each path's run also prints which variant of each kernel it took (the
min-path choice store, the encoder pair's tile).

The workflows' artifact writing (``predict``, ``evaluate_model``,
``train_model``) needs h5py and matplotlib, which the card's machine
lacks, so this script drives their device parts (``run_pipeline``, the
graph-search API, the train and eval steps and the BN refresher); the CPU
tests (``tests/test_torch_predict_evaluate.py``,
``tests/test_torch_training.py``) hold the artifacts. The export path reads no
HDF5: directory checkpoints and the ``torch.export`` artifact need none.

It prints one ``{"dp": {...}}`` line with the data-parallel path's
results, one ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits with code 2 and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

H, W, BATCH, NUM_CLASSES = 512, 1024, 8, 4
VOLUME = 20  # two full batches and a remainder of 4
W_NARROW, N_NARROW = 768, 4  # the predict path's second image shape
N_MAPS = BATCH * (NUM_CLASSES - 1)  # 24 maps per batch
# Card peaks for the bound (H100 SXM data sheet): 3.35 TB/s of HBM3;
# int32 ALU ops at half the 67 TFLOP/s float32 CUDA-core rate (64 INT32
# lanes per SM against 128 FP32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (TF32 is off)
TF32_FLOPS_PER_S = 495e12  # dense TF32 on the tensor cores
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
REPO = Path(__file__).resolve().parent
EXPORT_TIMEOUT_S = 300  # one CLI export, start-up included


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
    plateau ridges (zero-weight-edge races), sparse random 0/255, constant
    maps (0, 255 and 128 in turn: every candidate ties), or 255 bands of
    1-8 rows."""
    if family == "sparse":
        return (rng.random((n, w, h)) < 0.15).astype(np.uint8) * 255
    if family == "constant":
        values = np.array([0, 255, 128], np.uint8)[np.arange(n) % 3]
        return np.broadcast_to(values[:, None, None], (n, w, h)).copy()
    if family == "bands":
        rows = smooth_rows(rng, n, w, h - 8, max_step)
        width = rng.integers(1, 9, size=(n, 1))
        r = np.arange(h)[None, None, :]
        band = (r >= rows[..., None]) & (r < (rows + width)[..., None])
        return band.astype(np.uint8) * 255
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
    return layered_dataset(rng, n, h, w, num_classes)[0]


def layered_dataset(rng, n: int, h: int, w: int, num_classes: int):
    """:func:`layered_bscans` with their labels: ``(images (n, h, w, 1)
    uint8, labels (n, h, w, 1) uint8)``."""
    rows = np.arange(h)[:, None]
    levels = np.linspace(40, 220, num_classes)
    out = np.empty((n, h, w, 1), np.uint8)
    out_labels = np.empty((n, h, w, 1), np.uint8)
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
        out_labels[i, ..., 0] = labels
    return out, out_labels


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
    from oct_image_segmentation_models_torch.ops.minpath_cuda import (
        choice_store,
        delineate_cuda,
    )

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
        ("constant", 3, 96, 40, 1, 2),
        ("constant", 3, 96, 40, 2, 2),
        ("bands", 5, 256, 200, 1, 2),
        ("bands", 5, 256, 200, 2, 2),
        ("ridge", 5, 256, 1024, 1, 2),  # H = 1024, shared-memory choices
        ("bands", 3, 640, 1024, 1, 2),  # H = 1024, device-scratch choices
        ("plateau", 3, 600, 1024, 2, 3),  # max_grad 2, device scratch
        ("ridge", 4, 128, 64, 4, 4),  # max_grad 4: the run-time max_grad code
        ("bands", 3, 96, 40, 30, 4),  # max_grad 30, the largest
    ]
    stores = set()
    max_err = 0
    for family, n, w, h, g, step in cases:
        maps = torch.from_numpy(synthetic_maps(rng, family, n, w, h, step)).cuda()
        store = choice_store(w, h, g)
        stores.add(store)
        for tie in ("exact", "fast"):
            got = delineate_cuda(maps, max_grad=g, tie_parity=tie)
            want = delineate_reference(maps, max_grad=g, tie_parity=tie)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            print(
                f"kernel parity {family:8s} N={n:2d} W={w:4d} H={h:4d} g={g} "
                f"{tie:5s} ({store} choices): max |diff| {err}"
            )
            if not torch.equal(got, want):
                raise AssertionError(
                    f"CUDA min-path kernel disagrees with the plain version: "
                    f"{family} N={n} W={w} H={h} g={g} {tie}, "
                    f"{int((got != want).sum())} rows differ"
                )
    if stores != {"shared", "scratch"}:
        raise AssertionError(f"B1 parity hit only the {stores} choice store")
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
        choice_store,
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
        ("constant", 1, 3, 96, 40, 1, 2),
        ("bands", 1, 5, 256, 200, 2, 2),
        ("ridge", 1, 5, 256, 1024, 1, 2),  # H = 1024, shared-memory choices
        ("bands", 1, 3, 640, 1024, 1, 2),  # device-scratch choices
        ("ridge", 1, 4, 128, 64, 4, 4),  # max_grad 4: the run-time max_grad code
    ]
    stores = set()
    max_err = 0
    for family, b, mm, w, h, g, step in cases:
        maps_t = torch.from_numpy(synthetic_maps(rng, family, b * mm, w, h, step)).cuda()
        s2d = image_maps_to_s2d(maps_t.transpose(-1, -2).reshape(b, mm, h, w))
        store = choice_store(w, h, g)
        stores.add(store)
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
                f"s2d kernel parity {family:8s} B={b:2d} M={mm} W={w:4d} H={h:4d} "
                f"g={g} {tie:5s} ({store} choices): max |diff| {err}, vs B1 "
                f"{int((got - b1).abs().max())}"
            )
            if not (torch.equal(got, want) and torch.equal(got, b1)):
                raise AssertionError(
                    f"s2d min-path kernel disagrees: {family} B={b} M={mm} W={w} "
                    f"H={h} g={g} {tie}, {int((got != want).sum())} rows differ "
                    f"from the plain version, {int((got != b1).sum())} from B1"
                )
    if stores != {"shared", "scratch"}:
        raise AssertionError(f"B2 parity hit only the {stores} choice store")
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
        enc_pair_tile,
        fused_enc_pair_cuda,
    )
    from oct_image_segmentation_models_torch.ops.s2d_unet import phase_max_pool

    cases = [
        (BATCH, H // 4, W // 4, 128, 256),  # flagship level 1
        (2, 13, 37, 128, 256),  # ragged: nh, nw not multiples of the tile
        (2, 10, 20, 256, 512),  # 4C = 512, the second tile
        (2, 6, 16, 128, 128),  # nh = 6: the gate's tr = 2
        (2, 8, 12, 8, 64),  # 4Cin = 8, 4C = 64, called directly
    ]
    tiles = set()
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
        tile = enc_pair_tile(shape[4])
        tiles.add(tile)
        print(
            f"enc pair parity B={shape[0]} nh={shape[1]} nw={shape[2]} "
            f"4Cin={shape[3]} 4C={shape[4]} (tile {tile}): y2 max |diff| {err:.3e}, pooled "
            f"{pool_err:.3e} (tolerance {PAIR_ATOL:g}); pooled == phase max of "
            f"y2: {exact_pool}; |y2| max {float(want_y2.abs().max()):.3f}"
        )
        if not torch.isfinite(y2).all() or err > PAIR_ATOL or pool_err > PAIR_ATOL:
            raise AssertionError(f"encoder-pair kernel off its plain version: {shape}")
        if not exact_pool:
            raise AssertionError("pooled is not the phase max of the kernel's y2")
        if flagship is None:
            flagship = args
    if len(tiles) < 2:
        raise AssertionError(f"B3 parity hit only the {tiles} tile")
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


def _variant_counts(fn) -> dict:
    """The launches of a kernel split by variant: the min-path choice
    store or the encoder pair's tile."""
    return getattr(fn, "store_launches", None) or fn.tile_launches


def reset_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0
        counts = _variant_counts(fn)
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counts().items()}


def read_variants() -> dict:
    """The variants that launched since the last reset, with their counts."""
    return {
        name: {k: v for k, v in _variant_counts(fn).items() if v}
        for name, fn in kernel_counts().items()
        if fn.launches
    }


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


def run_volume(pipe, volume: np.ndarray, batch: int = BATCH):
    """A volume through a pipeline in batches of ``batch``, as
    ``VolumeSegmenter`` batches it -> numpy (labels, rows)."""
    n = volume.shape[0]
    pad = (-n) % batch
    if pad:
        volume = np.concatenate([volume, volume[-1:].repeat(pad, 0)])
    labels, rows = [], []
    for i in range(0, len(volume), batch):
        lab, _, r = pipe(torch.from_numpy(volume[i : i + batch]).pin_memory())
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
        f"{first_run_s:.2f} s (first call), launches {counts}, variants "
        f"{read_variants()}"
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
    print(
        f"folded path: {VOLUME} B-scans fast + {BATCH} exact, launches {counts}, "
        f"variants {read_variants()}"
    )
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
    print(f"fused-pair path: one batch, launches {counts}, variants {read_variants()}")
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


def check_staged_rows(tie: str, maps: np.ndarray, rows: np.ndarray, masks=None) -> None:
    """Rows of the staged path against the plain min-path on the maps the
    path returned, bit for bit; masks against ``create_area_mask`` of the
    rows."""
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.ops.boundary import create_area_mask
    from oct_image_segmentation_models_torch.ops.minpath import delineate_reference

    n, m, h, w = maps.shape
    if maps.dtype != np.uint8 or rows.dtype != np.uint16 or rows.shape != (n, m, w):
        raise AssertionError(f"maps {maps.dtype} {maps.shape}, rows {rows.dtype} {rows.shape}")
    maps_t = torch.from_numpy(maps).cuda().transpose(-1, -2).contiguous()
    with float32_precision():
        want = delineate_reference(maps_t, tie_parity=tie)
    if not np.array_equal(rows.astype(np.int64), want.cpu().numpy()):
        raise AssertionError(f"staged {tie}-tie rows at {h}x{w} differ from the plain min-path")
    msg = f"staged rows ({tie} ties, {n} B-scans at {h}x{w}) equal the plain min-path"
    if masks is not None:
        want_masks = create_area_mask(torch.from_numpy(rows).cuda().to(torch.float32), h)
        if not np.array_equal(masks, want_masks.cpu().numpy()):
            raise AssertionError(f"staged {tie}-tie masks differ from create_area_mask")
        msg += "; masks equal create_area_mask of the rows"
    print(msg)


def phase_predict_path(model, rng, volume: np.ndarray, s2d_labels: np.ndarray) -> dict:
    """The device part of the predict and evaluate workflows:
    ``run_pipeline`` (StagedPipeline: s2d probabilities, image maps, B1)
    on a mixed-shape set, in both tie modes; then the graph-search API and
    the float min-path."""
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.min_path_processing import graph_search
    from oct_image_segmentation_models_torch.ops.minpath import delineate_float
    from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda
    from oct_image_segmentation_models_torch.prediction.prediction import run_pipeline

    container, module = model
    config = container.get_config()
    loaded = LoadedModel("unet", module, config)
    narrow = layered_bscans(rng, N_NARROW, H, W_NARROW, NUM_CLASSES)
    images = list(volume) + list(narrow)  # two shapes: two buckets

    reset_counts()
    t0 = time.perf_counter()
    results = {
        tie: run_pipeline(
            loaded, config, images, BATCH, True, minpath_tie_parity=tie, device="cuda"
        )
        for tie in ("fast", "exact")
    }
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    counts, variants = read_counts(), read_variants()
    print(
        f"predict path: run_pipeline on {VOLUME} B-scans at {H}x{W} + {N_NARROW} at "
        f"{H}x{W_NARROW}, batch {BATCH}, both tie modes, in {first_run_s:.2f} s (first "
        f"calls), launches {counts}, variants {variants}"
    )
    if counts["minpath_dp"] < 1:
        raise AssertionError("the predict path never launched B1")
    if counts["minpath_dp_s2d"] or counts["s2d_enc_pair"]:
        raise AssertionError(f"the predict path launched other kernels: {counts}")

    def stacked(res, key, sel):
        return np.stack(res[key][sel])

    wide, tail = slice(0, VOLUME), slice(VOLUME, None)
    for tie, res in results.items():
        check_staged_rows(
            tie,
            stacked(res, "boundary_maps", wide),
            stacked(res, "gs_pred_segs", wide),
            stacked(res, "gs_masks", wide),
        )
        check_staged_rows(
            tie,
            stacked(res, "boundary_maps", tail),
            stacked(res, "gs_pred_segs", tail),
            stacked(res, "gs_masks", tail),
        )
    labels = stacked(results["fast"], "predicted_labels", wide)
    differ = int((labels != s2d_labels).sum())
    agree = 1.0 - differ / labels.size
    print(
        f"staged labels vs the fused s2d pipeline's, {VOLUME} B-scans: agreement "
        f"{agree:.6f} ({differ} of {labels.size} pixels differ)"
    )
    if agree < MIN_AGREEMENT:
        raise AssertionError(f"staged labels agree with the fused pipeline on {agree}")

    # The graph-search API on one batch's uint8 maps, (W, H) orientation.
    maps = stacked(results["exact"], "boundary_maps", slice(0, BATCH))
    maps_wh = maps.reshape(-1, H, W).transpose(0, 2, 1)
    before = delineate_cuda.launches
    gs_rows, _, _ = graph_search.segment_maps(
        maps_wh, None, graph_search.create_graph_structure((W, H)), device="cuda"
    )
    gs_launches = delineate_cuda.launches - before
    want = stacked(results["exact"], "gs_pred_segs", slice(0, BATCH)).reshape(-1, W)
    if gs_launches != 1 or not np.array_equal(gs_rows, want):
        raise AssertionError(
            f"segment_maps: {gs_launches} B1 launches, rows equal to the staged "
            f"exact rows: {np.array_equal(gs_rows, want)}"
        )
    print(f"segment_maps on {maps_wh.shape} uint8 maps: one B1 launch, rows equal the staged exact rows")

    # The float min-path (plain PyTorch on the card) against the CPU.
    fmaps = np.clip(
        maps_wh / 255.0 + rng.normal(0, 0.05, maps_wh.shape), 0, 1
    ).astype(np.float32)
    cpu_rows = delineate_float(torch.from_numpy(fmaps))
    fmaps_card = torch.from_numpy(fmaps).cuda()
    card_rows = delineate_float(fmaps_card)
    float_ms = time_cuda(lambda: delineate_float(fmaps_card), iters=1, reps=3, warmup=1)
    if not torch.equal(card_rows.cpu(), cpu_rows):
        raise AssertionError("delineate_float rows differ between the card and the CPU")
    print(
        f"delineate_float at {fmaps.shape}: card rows equal CPU rows, "
        f"{float_ms:.3f} ms on the card"
    )
    return {
        "launches": counts["minpath_dp"],
        "store_launches": variants.get("minpath_dp", {}),
        "segment_maps_launches": gs_launches,
        "labels_agreement_fused": agree,
        "labels_differ": differ,
        "delineate_float_ms": float_ms,
        "delineate_float_shape": fmaps.shape,
        "loaded": loaded,
        "config": config,
        "preprocess": container.get_preprocess_input_fn(),
    }


def predict_path_times(predict: dict, volume: np.ndarray) -> dict:
    """Per-image stage times of ``run_pipeline`` (warm, the uniform
    volume) in both tie modes, and the time to copy one batch's outputs
    to the host."""
    from oct_image_segmentation_models_torch.ops.inference import StagedPipeline
    from oct_image_segmentation_models_torch.prediction.prediction import (
        run_pipeline,
        to_host,
    )

    loaded, config = predict["loaded"], predict["config"]
    out = {}
    for tie in ("fast", "exact"):
        t0 = time.perf_counter()
        res = run_pipeline(
            loaded, config, volume, BATCH, True, minpath_tie_parity=tie, device="cuda"
        )
        out[f"staged_run_pipeline_{tie}_s"] = time.perf_counter() - t0
        for stage in ("predict", "convert", "graph"):
            out[f"staged_{stage}_{tie}_ms_per_image"] = (
                statistics.mean(res[f"{stage}_times"]) * 1e3
            )
    pipe = StagedPipeline(loaded.module, predict["preprocess"], device="cuda")
    batch = torch.from_numpy(volume[:BATCH]).pin_memory()
    labels, cat, maps = pipe.convert(pipe.predict_probs(batch))
    rows, masks = pipe.graph_search(maps)
    outputs = (labels, cat, maps, rows, masks)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        to_host(*outputs)
        times.append((time.perf_counter() - t0) * 1e3)
    out["host_copy_ms_per_batch"] = statistics.median(times)
    out["host_copy_bytes_per_batch"] = sum(t.numel() * t.element_size() for t in outputs)
    out["host_copy_categorical_bytes"] = cat.numel() * cat.element_size()
    return out


TRAIN_IMAGES = 32  # four batches of 8 per epoch
TRAIN_STEPS = 120  # the JAX bench's brief training (bench.py:543)
TRAIN_TIMED = 10
TRAIN_WARMUP = 2
CHECK_H, CHECK_W, CHECK_BATCH = 128, 256, 2
# One train step on the card against the CPU, same weights, batch and
# dropout mask, float32 on both (the step turns TF32 off itself): the
# losses and the BN statistics agree to float32 sums in another order.
STEP_LOSS_RTOL = 1e-4
STEP_STAT_ATOL = 1e-5
# The gradients are held against the float64 step on the CPU that takes
# the float32 step's own discrete choices, its ReLU gates and max-pool
# picks (``GateRecorder``): then the two differ by rounding alone, per
# tensor max|d| <= STEP_GRAD_RTOL * max|g| + STEP_GRAD_ATOL. Against the
# plain float64 step they do not: a few pre-activations within ~1e-5 of 0
# change sign between float32 and float64, and each such gate moves one
# pixel's gradient, which in a BatchNorm bias or a conv weight (sums that
# nearly cancel) is percents of the tensor's largest entry, on the CPU and
# on the card alike (``tools/torch_train_grad_probe.py``).
STEP_GRAD_RTOL = 1e-4
STEP_GRAD_ATOL = 1e-7
# The bias of a conv that feeds a batch-statistics BatchNorm has an exact
# gradient of 0: float noise on both sides, held below this share of the
# largest gradient.
ZERO_GRAD_SHARE = 1e-4


class GateRecorder:
    """Stands in for ``torch.nn.functional`` inside ``models/unet.py``
    (see :func:`unet_functional`). Without ``replay`` it records each
    ReLU's gate (x > 0) and each max-pool's picks of a forward; with
    ``replay``, another recorder, it applies that one's gates (``gates``)
    and picks (``picks``) in place of its own, in the same order."""

    def __init__(self, replay=None, gates=True, picks=True):
        self.gates, self.picks = [], []
        self._gates = iter(replay.gates) if replay is not None and gates else None
        self._picks = iter(replay.picks) if replay is not None and picks else None

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x):
        if self._gates is not None:
            return x * next(self._gates).to(x.device)
        self.gates.append((x > 0).cpu())
        return torch.nn.functional.relu(x)

    def max_pool2d(self, x, kernel_size, stride):
        if self._picks is not None:
            idx = next(self._picks).to(x.device)
            return torch.gather(x.flatten(2), 2, idx.flatten(2)).view(idx.shape)
        out, idx = torch.nn.functional.max_pool2d(x, kernel_size, stride, return_indices=True)
        self.picks.append(idx.cpu())
        return out


@contextlib.contextmanager
def unet_functional(recorder):
    """``models/unet.py`` calls ``recorder`` for its ``F.relu`` and
    ``F.max_pool2d`` inside the block."""
    from oct_image_segmentation_models_torch.models import unet as unet_module

    saved = unet_module.F
    unet_module.F = recorder
    try:
        yield recorder
    finally:
        unet_module.F = saved


def gate_flips(a: GateRecorder, b: GateRecorder) -> tuple:
    """(ReLU gates, max-pool picks) in which two forwards differ."""
    return (
        sum(int((x != y).sum()) for x, y in zip(a.gates, b.gates)),
        sum(int((x != y).sum()) for x, y in zip(a.picks, b.picks)),
    )


def _train_objects(module, seed: int, mesh=None, impl: str = "auto"):
    from oct_image_segmentation_models_torch.ops import losses, metrics
    from oct_image_segmentation_models_torch.parallel.train_step import (
        build_optimizer,
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    loss_fn = losses.custom_loss_objects["focal_dice_loss"]["function"](
        num_classes=NUM_CLASSES, is_y_true_sparse=True
    )
    metric_fn = metrics.dice_coef_macro(True, NUM_CLASSES)
    state = create_train_state(module, build_optimizer("adam", {"learning_rate": 1e-3}), mesh)
    return (
        state,
        make_train_step(module, loss_fn, metric_fn, mesh, impl),
        make_eval_step(module, loss_fn, metric_fn, mesh, impl),
    )


def check_train_step_card_vs_cpu(rng, seed: int) -> dict:
    """One full-width train step at batch 2 of 128x256 on the card and on
    the CPU in float32, from the same weights, batch and dropout mask,
    under the global TF32 defaults (the step sets its own precision). The
    gradients of each are held against the CPU float64 step that takes
    that step's ReLU gates and max-pool picks."""
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.models import unet as unet_module

    container = get_model_class("unet")(
        input_channels=1, num_classes=NUM_CLASSES, image_height=CHECK_H,
        image_width=CHECK_W, start_neurons=32, pool_layers=4, conv_layers=2,
    )
    card = container.build_model(generator=torch.Generator().manual_seed(seed + 1), device="cuda")
    initial = copy.deepcopy(card).cpu()
    images, labels = layered_dataset(rng, CHECK_BATCH, CHECK_H, CHECK_W, NUM_CLASSES)
    x = torch.from_numpy(images.astype(np.float32) / 255.0)
    y = torch.from_numpy(labels)
    masks = {}

    def shared_mask(t, generator):
        if "mask" not in masks:
            draw = torch.rand(t.shape, generator=torch.Generator().manual_seed(seed))
            masks["mask"] = draw < 1.0 - unet_module.DROPOUT_RATE
        return masks["mask"].to(t.device)

    def run(module, recorder):
        dev = next(module.parameters()).device
        state, step, _ = _train_objects(module, seed)
        with unet_functional(recorder):
            _, loss, metric = step(state, x.to(dev), y.to(dev), None)
        # the optimizer runs after the backward: the step's gradients are
        # still on the parameters afterwards
        grads = {k: p.grad.detach().cpu().double() for k, p in module.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in module.state_dict().items() if "running" in k}
        return float(loss), float(metric), grads, stats

    drawn = unet_module.dropout_mask
    unet_module.dropout_mask = shared_mask
    rec = {"card": GateRecorder(), "cpu": GateRecorder(), "cpu64": GateRecorder()}
    try:
        l_card, m_card, g_card, s_card = run(card, rec["card"])
        l_cpu, m_cpu, g_cpu, s_cpu = run(copy.deepcopy(initial), rec["cpu"])
        g64 = run(copy.deepcopy(initial).double(), rec["cpu64"])[2]
        g64_card = run(copy.deepcopy(initial).double(), GateRecorder(replay=rec["card"]))[2]
        g64_cpu = run(copy.deepcopy(initial).double(), GateRecorder(replay=rec["cpu"]))[2]
    finally:
        unet_module.dropout_mask = drawn
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    gmax = max(float(g.abs().max()) for g in g64.values())

    def err(got, want):
        return float((got - want).abs().max()) / (
            STEP_GRAD_RTOL * float(want.abs().max()) + STEP_GRAD_ATOL
        )

    zero_grad, rel = 0.0, []
    for k, g in g64.items():
        if k.startswith("blocks.") and k.endswith("conv.bias"):
            zero_grad = max(zero_grad, float(g_cpu[k].abs().max()), float(g_card[k].abs().max()))
            continue
        # each entry: the error over its allowance, then the same error
        # against the plain float64 step, relative to the tensor's max
        rel.append((
            err(g_card[k], g64_card[k]), err(g_cpu[k], g64_cpu[k]),
            float((g_card[k] - g).abs().max()) / float(g.abs().max()),
            float((g_cpu[k] - g).abs().max()) / float(g.abs().max()),
            k,
        ))
    card_worst, cpu_worst = max(r[0] for r in rel), max(r[1] for r in rel)
    plain_card, plain_cpu = max(r[2] for r in rel), max(r[3] for r in rel)
    flips_card, flips_cpu = gate_flips(rec["card"], rec["cpu64"]), gate_flips(rec["cpu"], rec["cpu64"])
    stat_err = max(float((s_card[k] - s_cpu[k]).abs().max()) for k in s_cpu)
    print(
        f"train step card vs CPU (start_neurons 32, batch {CHECK_BATCH} x {CHECK_H}x{CHECK_W}, "
        f"float32): loss {l_card:.6f} / {l_cpu:.6f} (rel {loss_err:.2e}, tolerance "
        f"{STEP_LOSS_RTOL:g}), metric {m_card:.6f} / {m_cpu:.6f}, BN statistics max |diff| "
        f"{stat_err:.2e} (tolerance {STEP_STAT_ATOL:g}), pre-BN conv bias gradients "
        f"{zero_grad / gmax:.2e} of max |g| (bound {ZERO_GRAD_SHARE:g})"
    )
    print(
        f"  gradients against the float64 step with the same ReLU gates and max-pool picks, "
        f"worst tensor's max |d| over {STEP_GRAD_RTOL:g} * max |g| + {STEP_GRAD_ATOL:g}: card "
        f"{card_worst:.3f}, CPU float32 {cpu_worst:.3f} (must be <= 1)"
    )
    print(
        f"  against the plain float64 step: worst tensor card {plain_card:.2e}, CPU float32 "
        f"{plain_cpu:.2e} of its max; (ReLU gates, max-pool picks) that differ from float64's: "
        f"card {flips_card}, CPU float32 {flips_cpu}"
    )
    for card_rel, cpu_rel, _, _, k in sorted(rel, reverse=True)[:3]:
        print(f"  gradient {k}: card {card_rel:.3f}, CPU float32 {cpu_rel:.3f} of the allowance")
    if not (np.isfinite(l_card) and loss_err <= STEP_LOSS_RTOL):
        raise AssertionError(f"card train-step loss {l_card} off the CPU's {l_cpu}")
    if card_worst > 1 or cpu_worst > 1 or zero_grad > ZERO_GRAD_SHARE * gmax:
        raise AssertionError(
            f"gradients off float64 with the same gates: card {card_worst}, CPU {cpu_worst} "
            f"of the allowance; zero share {zero_grad / gmax}"
        )
    if stat_err > STEP_STAT_ATOL:
        raise AssertionError(f"card BN statistics off the CPU's by {stat_err}")
    return {
        "loss_rel_err": loss_err,
        "grad_card_worst_of_allowance": card_worst,
        "grad_cpu_worst_of_allowance": cpu_worst,
        "grad_card_worst_rel_plain_float64": plain_card,
        "grad_cpu_worst_rel_plain_float64": plain_cpu,
        "gate_flips_card": flips_card,
        "gate_flips_cpu": flips_cpu,
        "zero_grad_share": zero_grad / gmax,
        "bn_stat_max_abs_err": stat_err,
    }


def train_flop(step, state, x, y, generator) -> int:
    """FLOPs (2 per multiply-add) of one train step's convolutions,
    forward and backward, counted by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step(state, x, y, generator)
    return counter.get_total_flops()


def phase_train_path(rng, seed: int) -> dict:
    """The training slice's device part at full width: the port's
    DataGenerator feeds ``train_step`` (focal + Dice, Adam 1e-3, float32)
    for ``TRAIN_STEPS`` steps at batch 8 of 512x1024, then ``eval_step``
    and the precise-BN ``BNRefresher``; the trained weights are served
    through the folded path (B1) and the s2d path (B2)."""
    from oct_image_segmentation_models_torch.common.data_generator import DataGenerator
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.parallel.train_step import load_batch_stats
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    out = {"step_check": check_train_step_card_vs_cpu(rng, seed)}
    container, module = build_unet(seed)
    preprocess = container.get_preprocess_input_fn()
    train_x, train_y = layered_dataset(rng, TRAIN_IMAGES, H, W, NUM_CLASSES)
    val_x, val_y = layered_dataset(rng, BATCH, H, W, NUM_CLASSES)
    test_x, test_y = layered_dataset(rng, BATCH, H, W, NUM_CLASSES)
    gen = DataGenerator(train_x, train_y, BATCH, [], "none", (), False, preprocess, seed=seed)
    val_gen = DataGenerator(val_x, val_y, BATCH, [], "none", (), False, preprocess, seed=seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().cuda(non_blocking=True)

    def batches():
        while True:
            for bx, by in gen:
                yield upload(bx), upload(by)
            gen.on_epoch_end()

    stream = batches()
    state, step, evaluate = _train_objects(module, seed)
    losses = []
    fixed = [next(stream) for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    for x, y in fixed[:TRAIN_WARMUP]:
        _, loss, _ = step(state, x, y, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for x, y in fixed[TRAIN_WARMUP:]:
        _, loss, _ = step(state, x, y, generator)
        losses.append(loss)
    t1.record()
    t1.synchronize()
    out["step_ms"] = t0.elapsed_time(t1) / TRAIN_TIMED
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["bscans_per_s"] = BATCH / out["step_ms"] * 1e3

    # The step's split: CUDA events that train_step's own phase hook
    # records at the end of its forward (with loss and metric), backward
    # and optimizer.
    phases = ("forward", "backward", "optimizer")
    splits = {name: [] for name in phases}
    for x, y in fixed[TRAIN_WARMUP:TRAIN_WARMUP + 5]:
        ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + phases}
        ev["start"].record()
        _, loss, _ = step(state, x, y, generator, on_phase=lambda name: ev[name].record())
        ev["optimizer"].synchronize()
        losses.append(loss)
        for a, b in zip(("start",) + phases, phases):
            splits[b].append(ev[a].elapsed_time(ev[b]))
    for name, values in splits.items():
        out[f"{name}_ms"] = statistics.median(values)
    flop = train_flop(step, state, *fixed[0], generator)
    out["gflop_per_step"] = flop / 1e9
    out["tflops"] = flop / 1e9 / out["step_ms"]
    out["bound_ms"] = flop / FP32_FLOPS_PER_S * 1e3
    profiled = profile_pipeline(lambda b: step(state, b[0], b[1], generator), fixed[1], calls=2)
    out.update({f"profile_{k}": v for k, v in profiled.items()})

    # Training on through the generator, host batches and uploads included.
    done = TRAIN_WARMUP + TRAIN_TIMED + 5 + 1 + 3
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    for _ in range(TRAIN_STEPS - done):
        x, y = next(stream)
        _, loss, _ = step(state, x, y, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    out["loop_s"] = time.perf_counter() - t_host
    out["loop_steps"] = TRAIN_STEPS - done
    out["loop_bscans_per_s"] = BATCH * out["loop_steps"] / out["loop_s"]
    losses = torch.stack(losses).cpu().numpy()
    out["losses_first_last"] = (float(losses[0]), float(losses[-1]))
    out["steps"] = int(state.step)

    vx, vy = next(iter(val_gen))
    vx, vy = upload(vx), upload(vy)
    val_loss, val_metric = evaluate(state, vx, vy)
    out["eval_ms"] = time_cuda(lambda: evaluate(state, vx, vy), iters=3, reps=3)
    out["val_loss"], out["val_metric"] = float(val_loss), float(val_metric)

    stat_batches = [
        upload(preprocess(train_x[i:i + BATCH].astype(np.float32)))
        for i in range(0, TRAIN_IMAGES, BATCH)
    ]
    refresher = BNRefresher(module)
    torch.cuda.synchronize()
    t_ref = time.perf_counter()
    precise = refresher(
        None, stat_batches, generator=torch.Generator(device="cuda").manual_seed(seed)
    )
    torch.cuda.synchronize()
    out["bn_refresh_ms"] = (time.perf_counter() - t_ref) * 1e3
    print(
        f"train path: {out['steps']} steps at batch {BATCH} x {H}x{W}, loss "
        f"{out['losses_first_last'][0]:.4f} -> {out['losses_first_last'][1]:.4f}; eval "
        f"loss {out['val_loss']:.4f}, dice_coef_macro {out['val_metric']:.4f}"
    )
    first, last = out["losses_first_last"]
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"training loss did not fall: {first} -> {last}")
    bad = [k for k, v in precise.items() if not torch.isfinite(v).all()]
    bad += [k for k, v in precise.items() if k.endswith("running_var") and not (v > 0).all()]
    if bad:
        raise AssertionError(f"precise BN statistics not finite or var <= 0: {bad[:4]}")
    load_batch_stats(module, precise)
    module.eval()

    # Serving the trained, precise-BN weights: folded path (B1), s2d (B2).
    config = container.get_config()
    folded = make_fused_pipeline(
        fold_batchnorm(module), preprocess, minpath_tie_parity="fast",
        return_maps=False, device="cuda",
    )
    segmenter = VolumeSegmenter(
        LoadedModel("unet", module, config), config, batch_size=BATCH, device="cuda"
    )
    if segmenter.kind != "s2d":
        raise AssertionError(f"VolumeSegmenter chose {segmenter.kind} for the trained U-Net")
    reset_counts()
    lab_fold, rows_fold = run_volume(folded, test_x)
    lab_s2d, rows_s2d = segmenter.segment_volume(test_x)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"train path serving: launches {counts}, variants {read_variants()}")
    if counts["minpath_dp"] < 1 or counts["minpath_dp_s2d"] < 1 or counts["s2d_enc_pair"]:
        raise AssertionError(f"serving the trained weights launched {counts}")
    check_rows("fast", lab_fold, rows_fold)
    check_rows("fast", lab_s2d, rows_s2d)
    truth = test_y[..., 0]
    for name, lab in (("folded", lab_fold), ("s2d", lab_s2d)):
        dice = float(np.mean([
            2 * ((lab == c) & (truth == c)).sum() / ((lab == c).sum() + (truth == c).sum())
            for c in range(NUM_CLASSES)
        ]))
        out[f"served_dice_{name}"] = dice
    out["served_agreement"] = float((lab_fold == lab_s2d).mean())
    out["launches"] = {k: counts[k] for k in ("minpath_dp", "minpath_dp_s2d")}
    print(
        f"trained weights served on {BATCH} held-out B-scans: dice_coef_macro folded "
        f"{out['served_dice_folded']:.4f}, s2d {out['served_dice_s2d']:.4f}; folded vs "
        f"s2d labels agreement {out['served_agreement']:.6f}"
    )
    return out


# --- the DeepLabV3+ path ---------------------------------------------------

DL_CHECK_H, DL_CHECK_W, DL_CHECK_BATCH = 64, 128, 2
DL_FWD_H, DL_FWD_W = 128, 256
DL_TRAIN_STEPS = 30
DL_TRAIN_TIMED = 5
DL_TRAIN_WARMUP = 2
# The card's DeepLab step against the replaying float64 step: the float32
# step itself, on the CPU as on the card, sits up to a few 1e-4 of a
# tensor's max off it. ``tools/torch_deeplab_grad_probe.py`` finds why:
# float32 rounding in the backbone's convolutions and BatchNorms, most of
# it entering in the stem and the first stage and carried down some 40
# layers; the worst tensors are the DSPP's pooled branch (its BatchNorm
# normalises over the batch alone), its projection and the last backbone
# BatchNorm. Float64 BatchNorm statistics do not remove it, nor a float64
# pooled branch; float64 convolutions and BatchNorms together take it to
# about 1e-5 at batch 8. Each tensor of the card's step is held to the
# larger of the U-Net's allowance and DL_GRAD_CPU_FACTOR times the CPU
# float32 step's own error.
DL_GRAD_CPU_FACTOR = 2.0


def build_deeplab(seed: int, h: int = H, w: int = W, device="cuda"):
    from oct_image_segmentation_models_torch.models import get_model_class

    container = get_model_class("deeplabv3plus")(
        input_channels=3, num_classes=NUM_CLASSES, image_height=h, image_width=w
    )
    module = container.build_model(
        generator=torch.Generator().manual_seed(seed), device=device
    )
    return container, module


def rgb(images: np.ndarray) -> np.ndarray:
    """Gray ``(..., 1)`` B-scans repeated over 3 channels."""
    return np.repeat(images, 3, axis=-1)


@contextlib.contextmanager
def deeplab_functional(recorder):
    """``models/resnet.py`` and the blocks of ``models/unet.py`` call
    ``recorder`` for their ``F.relu`` and ``F.max_pool2d`` inside."""
    from oct_image_segmentation_models_torch.models import resnet, unet

    saved = resnet.F, unet.F
    resnet.F = unet.F = recorder
    try:
        yield recorder
    finally:
        resnet.F, unet.F = saved


def deeplab_forward_card_vs_cpu(rng, seed: int) -> dict:
    """The eval-mode forward, plain and BN-folded, on the card against the
    CPU at 2 x 128x256 (both float32)."""
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.models.deeplabv3plus import fold_batchnorm

    container, card = build_deeplab(seed, DL_FWD_H, DL_FWD_W)
    cpu = copy.deepcopy(card).cpu()
    images = rgb(layered_bscans(rng, 2, DL_FWD_H, DL_FWD_W, NUM_CLASSES))
    x = torch.from_numpy(container.get_preprocess_input_fn()(images))
    out = {}
    for name, (a, b) in {
        "plain": (card, cpu), "folded": (fold_batchnorm(card), fold_batchnorm(cpu)),
    }.items():
        with torch.inference_mode(), float32_precision():
            p_card = a(x.cuda()).cpu()
            p_cpu = b(x)
        err = float((p_card - p_cpu).abs().max())
        agree = float((p_card.argmax(-1) == p_cpu.argmax(-1)).float().mean())
        print(
            f"deeplab {name} forward card vs CPU (2 x {DL_FWD_H}x{DL_FWD_W}): max |dp| "
            f"{err:.3e} (tolerance {PROB_ATOL:g}), argmax agreement {agree:.6f}"
        )
        if not torch.isfinite(p_card).all() or err > PROB_ATOL or agree < MIN_AGREEMENT:
            raise AssertionError(f"deeplab {name} card forward off the CPU's: {err}, {agree}")
        out[f"{name}_prob_max_abs_err"], out[f"{name}_argmax_agreement"] = err, agree
    return out


def deeplab_serving(container, module, volume: np.ndarray, label: str) -> dict:
    """The folded ``make_fused_pipeline`` and ``VolumeSegmenter`` on the
    3-channel ``volume`` in both tie modes through B1: rows against the
    plain min-path, no B2 or B3 launch."""
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models.deeplabv3plus import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    config = container.get_config()
    loaded = LoadedModel("deeplabv3plus", module, config)
    folded = fold_batchnorm(module)
    pipes = {
        tie: make_fused_pipeline(
            folded, container.get_preprocess_input_fn(), minpath_tie_parity=tie,
            return_maps=False, device="cuda",
        )
        for tie in ("fast", "exact")
    }
    segs = {
        tie: VolumeSegmenter(
            loaded, config, batch_size=BATCH, minpath_tie_parity=tie, device="cuda"
        )
        for tie in ("fast", "exact")
    }
    if any(seg.kind != "folded" for seg in segs.values()):
        raise AssertionError(f"VolumeSegmenter chose {segs['fast'].kind} for the DeepLab")
    reset_counts()
    results = {}
    for tie in ("fast", "exact"):
        results[("pipeline", tie)] = run_volume(pipes[tie], volume)
        results[("segmenter", tie)] = segs[tie].segment_volume(volume)
    torch.cuda.synchronize()
    counts = read_counts()
    print(
        f"deeplab serving ({label}): {len(volume)} B-scans through the folded pipeline "
        f"and VolumeSegmenter, both tie modes, launches {counts}, variants {read_variants()}"
    )
    if counts["minpath_dp"] < 1:
        raise AssertionError("deeplab serving never launched B1")
    if counts["minpath_dp_s2d"] or counts["s2d_enc_pair"]:
        raise AssertionError(f"deeplab serving launched other kernels: {counts}")
    for (path, tie), (labels, rows) in results.items():
        check_rows(tie, labels, rows)
        if not np.array_equal(labels, results[("pipeline", tie)][0]):
            raise AssertionError(f"VolumeSegmenter labels differ from the pipeline's ({tie})")
    return {
        "launches": counts["minpath_dp"],
        "pipes": pipes,
        "folded": folded,
        "preprocess": container.get_preprocess_input_fn(),
        "labels": results[("pipeline", "fast")][0],
    }


def deeplab_serving_times(serving: dict, volume: np.ndarray) -> dict:
    from oct_image_segmentation_models_torch._device import float32_precision

    batch = torch.from_numpy(volume[:BATCH]).pin_memory()
    out = {}
    for tie, pipe in serving["pipes"].items():
        ms = time_cuda(lambda: pipe(batch), iters=3)
        out[f"pipeline_{tie}_ms"] = ms
        out[f"pipeline_{tie}_bscans_per_s"] = BATCH / ms * 1e3
    preprocess = serving["preprocess"]
    folded = serving["folded"]
    with torch.inference_mode(), float32_precision():
        x = preprocess(batch.cuda())
        out["forward_gflop"] = forward_flop(folded, x) / 1e9
        out["forward_ms"] = time_cuda(lambda: folded(x), iters=3)
    out["forward_tflops"] = out["forward_gflop"] / out["forward_ms"]
    out["forward_bound_ms"] = out["forward_gflop"] * 1e9 / FP32_FLOPS_PER_S * 1e3
    out["pipeline_fast_tflops"] = out["forward_gflop"] / out["pipeline_fast_ms"]
    out.update(profile_pipeline(serving["pipes"]["fast"], batch))
    return out


def deeplab_step_card_vs_cpu(rng, seed: int) -> dict:
    """One DeepLab train step at batch 2 of 64x128 on the card and on the
    CPU in float32 from the same weights and batch; the gradients of each
    against the CPU float64 step that replays that step's ReLU gates and
    max-pool picks."""
    container, card = build_deeplab(seed + 2, DL_CHECK_H, DL_CHECK_W)
    initial = copy.deepcopy(card).cpu()
    images, labels = layered_dataset(rng, DL_CHECK_BATCH, DL_CHECK_H, DL_CHECK_W, NUM_CLASSES)
    x = torch.from_numpy(container.get_preprocess_input_fn()(rgb(images)))
    y = torch.from_numpy(labels)

    def run(module, recorder):
        dev = next(module.parameters()).device
        state, step, _ = _train_objects(module, seed)
        with deeplab_functional(recorder):
            _, loss, metric = step(state, x.to(dev), y.to(dev), None)
        grads = {k: p.grad.detach().cpu().double() for k, p in module.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in module.state_dict().items() if "running" in k}
        return float(loss), float(metric), grads, stats

    rec = {"card": GateRecorder(), "cpu": GateRecorder(), "cpu64": GateRecorder()}
    l_card, m_card, g_card, s_card = run(card, rec["card"])
    l_cpu, m_cpu, g_cpu, s_cpu = run(copy.deepcopy(initial), rec["cpu"])
    g64 = run(copy.deepcopy(initial).double(), rec["cpu64"])[2]
    g64_card = run(copy.deepcopy(initial).double(), GateRecorder(replay=rec["card"]))[2]
    g64_cpu = run(copy.deepcopy(initial).double(), GateRecorder(replay=rec["cpu"]))[2]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    gmax = max(float(g.abs().max()) for g in g64.values())

    def rel(got, want):
        return float((got - want).abs().max()) / float(want.abs().max())

    zero_grad, rows = 0.0, []
    for k, g in g64.items():
        if k.endswith("conv.bias"):  # every conv bias but the head's feeds a BatchNorm
            zero_grad = max(zero_grad, float(g_cpu[k].abs().max()), float(g_card[k].abs().max()))
            continue
        card_rel, cpu_rel = rel(g_card[k], g64_card[k]), rel(g_cpu[k], g64_cpu[k])
        allowed = max(STEP_GRAD_RTOL, DL_GRAD_CPU_FACTOR * cpu_rel)
        rows.append((card_rel / allowed, card_rel, cpu_rel, rel(g_card[k], g), rel(g_cpu[k], g), k))
    rows.sort(reverse=True)
    worst = rows[0][0]
    card_max, cpu_max = max(r[1] for r in rows), max(r[2] for r in rows)
    plain_card, plain_cpu = max(r[3] for r in rows), max(r[4] for r in rows)
    flips_card = gate_flips(rec["card"], rec["cpu64"])
    flips_cpu = gate_flips(rec["cpu"], rec["cpu64"])
    # the stem's running statistics reach ~1e2 (preprocessed inputs of
    # +-130): held relative to 1 + |value|
    stat_err = max(
        float(((s_card[k] - s_cpu[k]).abs() / (1 + s_cpu[k].abs())).max()) for k in s_cpu
    )
    print(
        f"deeplab train step card vs CPU (batch {DL_CHECK_BATCH} x {DL_CHECK_H}x{DL_CHECK_W}, "
        f"float32): loss {l_card:.6f} / {l_cpu:.6f} (rel {loss_err:.2e}, tolerance "
        f"{STEP_LOSS_RTOL:g}), metric {m_card:.6f} / {m_cpu:.6f}, BN statistics max |diff| / "
        f"(1 + |value|) {stat_err:.2e} (tolerance {STEP_STAT_ATOL:g}), pre-BN conv bias "
        f"gradients {zero_grad / gmax:.2e} of max |g| (bound {ZERO_GRAD_SHARE:g})"
    )
    print(
        f"  gradients against the float64 step with the same ReLU gates and max-pool picks, "
        f"worst tensor's max |d| / max |g|: card {card_max:.2e}, CPU float32 {cpu_max:.2e}; "
        f"card over its allowance (max of {STEP_GRAD_RTOL:g} and {DL_GRAD_CPU_FACTOR:g} x the "
        f"CPU's): {worst:.3f} (must be <= 1)"
    )
    print(
        f"  against the plain float64 step: worst tensor card {plain_card:.2e}, CPU float32 "
        f"{plain_cpu:.2e} of its max; (ReLU gates, max-pool picks) that differ from float64's: "
        f"card {flips_card}, CPU float32 {flips_cpu}"
    )
    for over, card_rel, cpu_rel, _, _, k in rows[:3]:
        print(f"  gradient {k}: card {card_rel:.2e}, CPU float32 {cpu_rel:.2e} of max |g|")
    if not (np.isfinite(l_card) and loss_err <= STEP_LOSS_RTOL):
        raise AssertionError(f"deeplab card train-step loss {l_card} off the CPU's {l_cpu}")
    if worst > 1 or zero_grad > ZERO_GRAD_SHARE * gmax:
        raise AssertionError(
            f"deeplab gradients off float64 with the same gates: {worst} of the allowance "
            f"({rows[0][-1]}); zero share {zero_grad / gmax}"
        )
    if stat_err > STEP_STAT_ATOL:
        raise AssertionError(f"deeplab card BN statistics off the CPU's by {stat_err}")
    return {
        "loss_rel_err": loss_err,
        "grad_card_worst_rel": card_max,
        "grad_cpu_worst_rel": cpu_max,
        "grad_card_worst_of_allowance": worst,
        "grad_worst_tensor": rows[0][-1],
        "grad_card_worst_rel_plain_float64": plain_card,
        "grad_cpu_worst_rel_plain_float64": plain_cpu,
        "gate_flips_card": flips_card,
        "gate_flips_cpu": flips_cpu,
        "zero_grad_share": zero_grad / gmax,
        "bn_stat_rel_err": stat_err,
    }


def deeplab_train(rng, seed: int) -> dict:
    """``DL_TRAIN_STEPS`` train steps at batch 8 of 512x1024 from the
    port's DataGenerator (focal + Dice, Adam 1e-3, float32), an eval step,
    one BNRefresher pass, and the trained weights served through B1."""
    from oct_image_segmentation_models_torch.common.data_generator import DataGenerator
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.parallel.train_step import load_batch_stats

    container, module = build_deeplab(seed + 3)
    preprocess = container.get_preprocess_input_fn()
    train_x, train_y = layered_dataset(rng, 2 * BATCH, H, W, NUM_CLASSES)
    train_x = rgb(train_x)
    gen = DataGenerator(train_x, train_y, BATCH, [], "none", (), False, preprocess, seed=seed)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().cuda(non_blocking=True)

    def batches():
        while True:
            for bx, by in gen:
                yield upload(bx), upload(by)
            gen.on_epoch_end()

    stream = batches()
    state, step, evaluate = _train_objects(module, seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    out, losses = {}, []
    fixed = [next(stream) for _ in range(DL_TRAIN_WARMUP + DL_TRAIN_TIMED)]
    for bx, by in fixed[:DL_TRAIN_WARMUP]:
        losses.append(step(state, bx, by, generator)[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases = ("forward", "backward", "optimizer")
    splits = {name: [] for name in ("step",) + phases}
    for bx, by in fixed[DL_TRAIN_WARMUP:]:
        ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + phases}
        ev["start"].record()
        losses.append(step(state, bx, by, generator, on_phase=lambda n: ev[n].record())[1])
        ev["optimizer"].synchronize()
        for a, b in zip(("start",) + phases, phases):
            splits[b].append(ev[a].elapsed_time(ev[b]))
        splits["step"].append(ev["start"].elapsed_time(ev["optimizer"]))
    for name, values in splits.items():
        out[f"{name}_ms"] = statistics.median(values)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["bscans_per_s"] = BATCH / out["step_ms"] * 1e3
    flop = train_flop(step, state, *fixed[0], generator)
    out["gflop_per_step"] = flop / 1e9
    out["tflops"] = flop / 1e9 / out["step_ms"]
    out["bound_ms"] = flop / FP32_FLOPS_PER_S * 1e3
    done = DL_TRAIN_WARMUP + DL_TRAIN_TIMED + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DL_TRAIN_STEPS - done):
        bx, by = next(stream)
        losses.append(step(state, bx, by, generator)[1])
    torch.cuda.synchronize()
    out["loop_s"] = time.perf_counter() - t0
    out["loop_bscans_per_s"] = BATCH * (DL_TRAIN_STEPS - done) / out["loop_s"]
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[0]), float(losses[-1])
    out["losses_first_last"], out["steps"] = (first, last), int(state.step)

    vx, vy = fixed[0]
    val_loss, val_metric = evaluate(state, vx, vy)
    out["eval_ms"] = time_cuda(lambda: evaluate(state, vx, vy), iters=2, reps=3)
    out["val_loss"], out["val_metric"] = float(val_loss), float(val_metric)
    stat_batches = [upload(preprocess(train_x[i:i + BATCH])) for i in range(0, len(train_x), BATCH)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    precise = BNRefresher(module)(
        None, stat_batches, generator=torch.Generator(device="cuda").manual_seed(seed)
    )
    torch.cuda.synchronize()
    out["bn_refresh_ms"] = (time.perf_counter() - t0) * 1e3
    print(
        f"deeplab train: {out['steps']} steps at batch {BATCH} x {H}x{W}, loss {first:.4f} -> "
        f"{last:.4f}; eval loss {out['val_loss']:.4f}, dice_coef_macro {out['val_metric']:.4f}"
    )
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"deeplab training loss did not fall: {first} -> {last}")
    bad = [k for k, v in precise.items() if not torch.isfinite(v).all()]
    bad += [k for k, v in precise.items() if k.endswith("running_var") and not (v > 0).all()]
    if bad:
        raise AssertionError(f"deeplab precise BN statistics not finite or var <= 0: {bad[:4]}")
    load_batch_stats(module, precise)
    module.eval()
    test_x, test_y = layered_dataset(rng, BATCH, H, W, NUM_CLASSES)
    served = deeplab_serving(container, module, rgb(test_x), "trained weights")
    truth = test_y[..., 0]
    out["served_dice"] = float(np.mean([
        2 * ((served["labels"] == c) & (truth == c)).sum()
        / ((served["labels"] == c).sum() + (truth == c).sum())
        for c in range(NUM_CLASSES)
    ]))
    out["served_launches"] = served["launches"]
    print(f"deeplab trained weights on {BATCH} held-out B-scans: dice_coef_macro {out['served_dice']:.4f}")
    return out


def phase_deeplab_path(rng, seed: int, volume: np.ndarray) -> dict:
    """DeepLabV3+ at full width (ResNet50 to conv4, 3-channel 512x1024
    B-scans, 4 classes, batch 8, seeded random weights): forward card vs
    CPU, serving through B1, the train step card vs CPU, training and the
    trained weights served through B1."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"forward_check": deeplab_forward_card_vs_cpu(rng, seed)}
    container, module = build_deeplab(seed)
    volume3 = rgb(volume)
    serving = deeplab_serving(container, module, volume3, "random weights")
    out["times"] = deeplab_serving_times(serving, volume3)
    out["launches"] = serving["launches"]
    del serving, module
    torch.cuda.empty_cache()
    out["step_check"] = deeplab_step_card_vs_cpu(rng, seed)
    out["train"] = deeplab_train(rng, seed)
    out["launches"] += out["train"]["served_launches"]
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


# --- the export path -----------------------------------------------------

EXPORT_TIMED = 5  # timed calls per pipeline (median), after EXPORT_WARMUP
EXPORT_WARMUP = 2


def serve_batches(pipe, volume: np.ndarray, batch: int = BATCH):
    """``volume`` through ``pipe`` in batches of ``batch`` and a remainder
    (8, 8, 4 for 20 B-scans) -> numpy (labels, maps, rows)."""
    outs = [
        pipe(torch.from_numpy(volume[i : i + batch]).pin_memory())
        for i in range(0, len(volume), batch)
    ]
    return tuple(torch.cat([o[k] for o in outs]).cpu().numpy() for k in range(3))


def stopwatch_ms(pipe, batch) -> float:
    """Median ms per call of ``pipe`` on ``batch`` by ``DeviceStopwatch``."""
    from oct_image_segmentation_models_torch.common.profiling import DeviceStopwatch

    for _ in range(EXPORT_WARMUP):
        pipe(batch)
    sw = DeviceStopwatch()
    times = []
    for _ in range(EXPORT_TIMED):
        sw.start()
        out = pipe(batch)
        times.append(sw.stop(out) * 1e3)
    return statistics.median(times)


def cli_export(checkpoint, artifact, *flags) -> subprocess.Popen:
    """``python -m oct_image_segmentation_models_torch.cli export`` of
    ``checkpoint`` at 512x1024 with a symbolic batch, for the card."""
    return subprocess.Popen(
        [
            sys.executable, "-m", "oct_image_segmentation_models_torch.cli", "export",
            str(checkpoint), str(artifact), "--height", str(H), "--width", str(W),
            "--dynamic-batch", "--platforms", "cuda", *flags,
        ],
        cwd=str(REPO),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def finish_export(proc: subprocess.Popen, t0: float, name: str) -> float:
    try:
        out, _ = proc.communicate(timeout=EXPORT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"cli export of {name} outlived {EXPORT_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli export of {name} failed ({proc.returncode}):\n{out}")
    print(f"cli export of {name}: {seconds:.2f} s; {out.strip().splitlines()[-1]}")
    return seconds


def serve_artifact(name, artifact, eager, volume, tie, kernel, export_s) -> dict:
    """Load ``artifact`` on the card and serve ``volume`` through it in
    batches of 8, 8, 4: ``kernel`` (B1 or B2) must launch and no other
    kernel, the rows must pass ``check_rows``, and labels, maps and rows
    must equal ``eager``'s (the same forward and weights) bit for bit."""
    from oct_image_segmentation_models_torch.common.export import load_exported_pipeline

    t0 = time.perf_counter()
    art = load_exported_pipeline(artifact)
    load_s = time.perf_counter() - t0
    if art.metadata["minpath_tie_parity"] != tie or art.input_shape[0] is not None:
        raise AssertionError(f"{name}: metadata {art.metadata}")
    reset_counts()
    got = serve_batches(art, volume)
    torch.cuda.synchronize()
    counts = read_counts()
    variants = read_variants()
    other = "minpath_dp_s2d" if kernel == "minpath_dp" else "minpath_dp"
    if counts[kernel] < 1 or counts[other] or counts["s2d_enc_pair"]:
        raise AssertionError(f"{name}: the artifact launched {counts}, not {kernel} alone")
    check_rows(tie, got[0], got[2])
    want = serve_batches(eager, volume)
    for what, a, b in zip(("labels", "maps", "rows"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
            agree = float((got[0] == want[0]).mean())
            raise AssertionError(
                f"{name}: the artifact's {what} differ from eager serving "
                f"(labels agreement {agree:.6f})"
            )
    batch = torch.from_numpy(volume[:BATCH]).pin_memory()
    art_ms = stopwatch_ms(art, batch)
    eager_ms = stopwatch_ms(eager, batch)
    print(
        f"export_path {name} ({art.metadata['optimized_forward']}, {tie} ties): launches "
        f"{counts}, variants {variants}; labels, maps and rows bit-equal to eager serving "
        f"on {len(volume)} B-scans (batches 8, 8, 4); artifact {art_ms:.3f} ms/batch, "
        f"eager {eager_ms:.3f} ms/batch (batch {BATCH}); export {export_s:.2f} s, load "
        f"{load_s:.3f} s"
    )
    return {
        "kernel": kernel,
        "launches": counts[kernel],
        "variants": variants,
        "optimized_forward": art.metadata["optimized_forward"],
        "tie": tie,
        "artifact_ms_per_batch": art_ms,
        "eager_ms_per_batch": eager_ms,
        "export_s": export_s,
        "load_s": load_s,
    }


def phase_export_path(model, seed: int, volume: np.ndarray) -> dict:
    """The deployment path from files, without h5py: the bench's U-Net and
    the full-width DeepLabV3+ saved as directory checkpoints, exported by
    the CLI to ``torch.export`` artifacts for the card (a symbolic batch
    at 512x1024), loaded, and served through B2 (the optimized U-Net, both
    tie modes) and B1 (``--no-optimize`` U-Net, DeepLabV3+ fast ties)."""
    import tempfile

    from oct_image_segmentation_models_torch.common.model_io import (
        load_model_and_config,
        save_model_dir,
    )
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops.inference import (
        make_fused_pipeline,
        select_optimized_forward,
    )

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    container, module = model
    dl_container, dl_module = build_deeplab(seed)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_model_dir(tmp / "unet.orbax", "unet", container.get_config(), module.state_dict())
        save_model_dir(
            tmp / "deeplab.orbax", "deeplabv3plus", dl_container.get_config(),
            dl_module.state_dict(),
        )
        del dl_module
        jobs = {  # name: (checkpoint, flags, tie, kernel)
            "unet_s2d_fast": ("unet.orbax", (), "fast", "minpath_dp_s2d"),
            "unet_s2d_exact": ("unet.orbax", ("--minpath-tie-parity", "exact"), "exact",
                               "minpath_dp_s2d"),
            "unet_parity_fast": ("unet.orbax", ("--no-optimize",), "fast", "minpath_dp"),
            "deeplab_folded_fast": ("deeplab.orbax", (), "fast", "minpath_dp"),
        }
        # The four exports run at once, each timed from its start.
        t0 = time.perf_counter()
        procs = {
            name: cli_export(tmp / ckpt, tmp / f"{name}.pt2", *flags)
            for name, (ckpt, flags, _, _) in jobs.items()
        }
        export_s = {
            name: finish_export(proc, t0, f"{name} (four exports at once)")
            for name, proc in procs.items()
        }
        loaded = {
            ckpt: load_model_and_config(tmp / ckpt)
            for ckpt in ("unet.orbax", "deeplab.orbax")
        }
        for name, (ckpt, flags, tie, kernel) in jobs.items():
            model_loaded, config = loaded[ckpt]
            forward, kind = select_optimized_forward(
                model_loaded.module, optimize="--no-optimize" not in flags
            )
            preprocess = get_model_class(model_loaded.name)(**config).get_preprocess_input_fn()
            eager = make_fused_pipeline(
                None if kind == "s2d" else forward, preprocess,
                labels_apply_fn=forward if kind == "s2d" else None,
                num_classes=NUM_CLASSES, minpath_tie_parity=tie, device="cuda",
            )
            vol = rgb(volume) if ckpt == "deeplab.orbax" else volume
            out[name] = serve_artifact(
                name, tmp / f"{name}.pt2", eager, vol, tie, kernel, export_s[name]
            )
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# --- the data-parallel path ----------------------------------------------

DP_STEPS = 3  # steps of the world-of-one run held against the one-device step
DP_TIMED = 6  # steps timed per step variant, in turns
DP_RANKS = 2  # ranks that share the card over gloo
DP_LOCAL_BATCH = BATCH // DP_RANKS
DP_STAT_BATCHES = 2  # stat batches per rank for the cross-rank refresher
DP_TIMEOUT_S = 600  # a rank that outlives this fails the phase
DP_COLLECTIVE_TIMEOUT = 300  # seconds a collective may wait
# DDP at world 1 against the one-device step on the same card, both under
# deterministic algorithms: the same kernels on the same data, so every
# parameter, running statistic and loss must be equal bit for bit. (With
# cuDNN's default algorithms two identical runs part from the second step:
# tools/torch_bn_drift_probe.py.) Two ranks against the per-replica
# definition: loss and metric within DP_LOSS_RTOL, running statistics
# within DP_STAT_ATOL (means of two float32 values in another order), the
# gradients as the card-vs-CPU step check holds them (STEP_GRAD_*).
DP_STAT_ATOL = 1e-5
DP_LOSS_RTOL = 1e-5
# The cross-rank refresher against the one-process one: the same per-batch
# statistics summed in another order.
DP_REFRESH_RTOL, DP_REFRESH_ATOL = 1e-5, 1e-6


def _pre_bn_bias(key: str) -> bool:
    return key.startswith("blocks.") and key.endswith(".conv.bias")


@contextlib.contextmanager
def deterministic_algorithms():
    """Deterministic kernels inside (cuDNN's convolutions included), the
    caller's settings after. Yields the list of warnings raised inside:
    an op that has no deterministic kernel warns rather than fails."""
    prev = (
        torch.are_deterministic_algorithms_enabled(),
        torch.is_deterministic_algorithms_warn_only_enabled(),
        torch.backends.cudnn.deterministic,
    )
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]


def nondeterministic_ops(caught) -> list:
    return sorted({
        str(w.message).split(" does not have a deterministic")[0]
        for w in caught
        if "does not have a deterministic" in str(w.message)
    })


def world1_runs(base, batches, mesh, seed: int) -> dict:
    """``DP_STEPS`` steps through DDP over ``mesh`` and through the
    one-device step, each from ``base``'s weights with the same batches
    and dropout generator -> {name: (module, state, step, generator,
    losses)}."""
    runs = {}
    for name, kwargs in (("ddp", {"mesh": mesh, "impl": "shard_map"}), ("one", {})):
        module = copy.deepcopy(base)
        state, step, _ = _train_objects(module, seed, **kwargs)
        gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        losses = [step(state, x, y, gen)[1] for x, y in batches]
        runs[name] = (module, state, step, gen, torch.stack(losses).cpu().numpy())
    return runs


def dp_world_of_one(rng, model, seed: int) -> dict:
    """``impl="shard_map"`` (DDP) over a world of one on NCCL, at full
    width, against the one-device step from the same weights, batches and
    dropout generator, both under deterministic algorithms; then both
    timed in turns with the default algorithms."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from oct_image_segmentation_models_torch.parallel import mesh as mesh_lib

    container, base = model
    images, labels = layered_dataset(rng, BATCH * DP_STEPS, H, W, NUM_CLASSES)
    batches = [
        (
            torch.from_numpy(images[i:i + BATCH].astype(np.float32) / 255.0).cuda(),
            torch.from_numpy(labels[i:i + BATCH]).cuda(),
        )
        for i in range(0, BATCH * DP_STEPS, BATCH)
    ]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_distributed(
            "cuda", rank=0, world_size=1, init_method=f"file://{tmp}/store",
            timeout=timedelta(seconds=DP_COLLECTIVE_TIMEOUT),
        )
        try:
            mesh = mesh_lib.create_mesh(device="cuda:0")
            if dist.get_backend() != "nccl" or mesh.world != 1:
                raise AssertionError(f"world of one on {dist.get_backend()}, {mesh.world}")
            with deterministic_algorithms() as caught:
                runs = world1_runs(base, batches, mesh, seed)
            out["nondeterministic_ops"] = nondeterministic_ops(caught)
            want = runs["one"][0].state_dict()
            got = runs["ddp"][0].state_dict()
            for kind, keys in (
                ("param", [k for k in want if "running" not in k]),
                ("stat", [k for k in want if "running" in k]),
            ):
                out[kind] = max(float((got[k] - want[k]).abs().max()) for k in keys)
            out["loss_max_abs_err"] = float(np.max(np.abs(runs["ddp"][4] - runs["one"][4])))
            if out["param"] or out["stat"] or out["loss_max_abs_err"]:
                raise AssertionError(f"DDP at world 1 is not the one-device step: {out}")
            # Times in turns (one, ddp, ddp, one, ...), default algorithms.
            times = {"one": [], "ddp": []}
            x, y = batches[-1]
            for name in ["one", "ddp", "ddp", "one"] * (DP_TIMED // 2):
                _, state, step, gen, _ = runs[name]
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                step(state, x, y, gen)
                stop.record()
                stop.synchronize()
                times[name].append(start.elapsed_time(stop))
            out["one_device_step_ms"] = statistics.median(times["one"])
            out["ddp_world1_step_ms"] = statistics.median(times["ddp"])
        finally:
            dist.destroy_process_group()
    print(
        f"dp world of one (NCCL, DDP, batch {BATCH} x {H}x{W}, {DP_STEPS} Adam steps under "
        f"deterministic algorithms) vs the one-device step, bit for bit: params max |d| "
        f"{out['param']:.2e}, running stats {out['stat']:.2e}, losses {out['loss_max_abs_err']:.2e} "
        f"(tolerance 0); ops without a deterministic kernel: "
        f"{out['nondeterministic_ops'] or 'none'}; step {out['ddp_world1_step_ms']:.3f} ms with "
        f"DDP, {out['one_device_step_ms']:.3f} ms without"
    )
    return out


def _dp_rank_seed(seed: int, rank: int) -> int:
    return seed * 100 + rank


def dp_rank(rank: int, workdir: str, seed: int) -> None:
    """One of ``DP_RANKS`` ranks that share ``cuda:0`` over gloo (NCCL
    refuses two ranks on one device). Runs in a process of its own, started
    with the ``spawn`` method; writes its results to ``workdir``."""
    from datetime import timedelta

    import torch.distributed as dist

    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.parallel import mesh as mesh_lib
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    torch.cuda.set_device(0)
    inputs = torch.load(f"{workdir}/inputs.pt")
    mesh_lib.init_distributed(
        "cuda", rank=rank, world_size=DP_RANKS, init_method=f"file://{workdir}/store",
        backend="gloo", timeout=timedelta(seconds=DP_COLLECTIVE_TIMEOUT),
    )
    try:
        mesh = mesh_lib.create_mesh(local_size=DP_RANKS, device="cuda:0")
        container, module = build_unet(seed)
        module.load_state_dict(inputs["weights"])
        out = {"rank": mesh.rank, "node": mesh.node, "local_rank": mesh.local_rank}

        # One step from common weights, each rank on its rows.
        rows = mesh.local_rows(BATCH)
        train_module = copy.deepcopy(module)
        state, step, _ = _train_objects(train_module, seed, mesh=mesh, impl="shard_map")
        gen = torch.Generator(device="cuda").manual_seed(_dp_rank_seed(seed, rank))
        x, y = inputs["x"][rows].cuda(), inputs["y"][rows].cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss, metric = step(state, x, y, gen)
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
        out["loss"], out["metric"] = float(loss), float(metric)
        out["grads"] = {k: p.grad.cpu() for k, p in train_module.named_parameters()}
        out["stats"] = {
            k: v.cpu() for k, v in train_module.state_dict().items() if "running" in k
        }
        del train_module, state, step

        # The cross-rank precise-BN refresher on this rank's batches.
        refresher = BNRefresher(module, deterministic=True)
        batches = [b.cuda() for b in inputs["stat_x"][rank]]
        out["refreshed"] = {
            k: v.cpu() for k, v in refresher(None, batches, cross_process=True).items()
        }

        # Serving: VolumeSegmenter over the mesh (s2d, B2) and the folded
        # pipeline over the mesh (B1), both tie modes.
        config = container.get_config()
        volume = inputs["volume"].numpy()
        reset_counts()
        for tie in ("fast", "exact"):
            seg = VolumeSegmenter(
                LoadedModel("unet", module, config), config, batch_size=BATCH,
                minpath_tie_parity=tie, mesh=mesh,
            )
            out[f"seg_{tie}"] = seg.segment_volume(volume)
        out["b2_launches"] = read_counts()
        reset_counts()
        for tie in ("fast", "exact"):
            pipe = make_fused_pipeline(
                fold_batchnorm(module), container.get_preprocess_input_fn(),
                minpath_tie_parity=tie, return_maps=False, mesh=mesh,
            )
            out[f"folded_{tie}"] = run_volume(pipe, volume)
        torch.cuda.synchronize()
        out["b1_launches"] = read_counts()
        torch.save(out, f"{workdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_two_ranks(rng, model, volume: np.ndarray, seed: int) -> dict:
    """``DP_RANKS`` ranks on the card over gloo, spawned, against the
    per-replica definition computed here on the card."""
    import multiprocessing
    import tempfile

    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    container, base = model
    images, labels = layered_dataset(rng, BATCH, H, W, NUM_CLASSES)
    stat_x = layered_bscans(rng, DP_RANKS * DP_STAT_BATCHES * DP_LOCAL_BATCH, H, W, NUM_CLASSES)
    stat_x = torch.from_numpy(stat_x.astype(np.float32) / 255.0).reshape(
        DP_RANKS, DP_STAT_BATCHES, DP_LOCAL_BATCH, H, W, 1
    )
    inputs = {
        "weights": {k: v.cpu() for k, v in base.state_dict().items()},
        "x": torch.from_numpy(images.astype(np.float32) / 255.0),
        "y": torch.from_numpy(labels),
        "stat_x": stat_x,
        "volume": torch.from_numpy(volume),
    }
    out = {}
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        torch.save(inputs, f"{workdir}/inputs.pt")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_rank, args=(r, workdir, seed)) for r in range(DP_RANKS)]
        for p in procs:
            p.start()
        try:
            deadline = time.time() + DP_TIMEOUT_S
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.time()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        out["ranks_wall_s"] = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0] * DP_RANKS:
            raise AssertionError(f"dp ranks exited with {codes} (a failure or a hang)")
        ranks = [torch.load(f"{workdir}/rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]

    # The per-replica definition: the one-device step on each rank's rows
    # with its generator, then the means.
    local = []
    for r in range(DP_RANKS):
        module = copy.deepcopy(base)
        state, step, _ = _train_objects(module, seed)
        gen = torch.Generator(device="cuda").manual_seed(_dp_rank_seed(seed, r))
        rows = slice(r * DP_LOCAL_BATCH, (r + 1) * DP_LOCAL_BATCH)
        _, loss, metric = step(state, inputs["x"][rows].cuda(), inputs["y"][rows].cuda(), gen)
        local.append((
            float(loss), float(metric),
            {k: p.grad.cpu() for k, p in module.named_parameters()},
            {k: v.cpu() for k, v in module.state_dict().items() if "running" in k},
        ))
        del module, state, step
    want_loss = sum(x[0] for x in local) / DP_RANKS
    want_metric = sum(x[1] for x in local) / DP_RANKS
    got = ranks[0]
    for other in ranks[1:]:
        for k in got["grads"]:
            if not torch.equal(got["grads"][k], other["grads"][k]):
                raise AssertionError(f"ranks hold different averaged gradients for {k}")
        if (got["loss"], got["metric"]) != (other["loss"], other["metric"]):
            raise AssertionError("ranks hold different mean losses")
    loss_err = abs(got["loss"] - want_loss) / abs(want_loss)
    metric_err = abs(got["metric"] - want_metric) / max(abs(want_metric), 1e-12)
    gmax = max(float(g.abs().max()) for g in local[0][2].values())
    grad_err, zero_grad = 0.0, 0.0
    for k, g in got["grads"].items():
        want = sum(x[2][k] for x in local) / DP_RANKS
        if _pre_bn_bias(k):
            zero_grad = max(zero_grad, float(g.abs().max()), float(want.abs().max()))
            continue
        err = float((g - want).abs().max()) / (
            STEP_GRAD_RTOL * float(want.abs().max()) + STEP_GRAD_ATOL
        )
        grad_err = max(grad_err, err)
    stat_err = max(
        float((got["stats"][k] - sum(x[3][k] for x in local) / DP_RANKS).abs().max())
        for k in got["stats"]
    )
    out.update(
        step_loss_rel_err=loss_err, step_metric_rel_err=metric_err,
        step_grad_worst_of_allowance=grad_err, step_zero_grad_share=zero_grad / gmax,
        step_stat_max_abs_err=stat_err, rank_step_s=[r["step_s"] for r in ranks],
    )
    print(
        f"dp two ranks on one card (gloo, local batch {DP_LOCAL_BATCH} x {H}x{W}), one step "
        f"against the per-replica definition: loss {got['loss']:.6f} / {want_loss:.6f} (rel "
        f"{loss_err:.2e}), metric rel {metric_err:.2e} (tolerance {DP_LOSS_RTOL:g}), gradients "
        f"worst tensor {grad_err:.3f} of {STEP_GRAD_RTOL:g} * max |g| + {STEP_GRAD_ATOL:g}, "
        f"pre-BN conv biases {zero_grad / gmax:.2e} of max |g| (bound {ZERO_GRAD_SHARE:g}), "
        f"running stats max |d| {stat_err:.2e} (tolerance {DP_STAT_ATOL:g})"
    )
    if loss_err > DP_LOSS_RTOL or metric_err > DP_LOSS_RTOL:
        raise AssertionError(f"two-rank loss/metric off the per-replica mean: {loss_err}, {metric_err}")
    if grad_err > 1 or zero_grad > ZERO_GRAD_SHARE * gmax or stat_err > DP_STAT_ATOL:
        raise AssertionError(f"two-rank step off the per-replica definition: {grad_err}, {stat_err}")

    # The cross-rank refresher against the one-process one over all batches.
    batches = [b.cuda() for b in stat_x.reshape(-1, DP_LOCAL_BATCH, H, W, 1)]
    want_stats = BNRefresher(base, deterministic=True)(None, batches)
    refresh_err = 0.0
    for k, w in want_stats.items():
        g = got["refreshed"][k]
        excess = (g - w.cpu()).abs() - (DP_REFRESH_ATOL + DP_REFRESH_RTOL * w.cpu().abs())
        refresh_err = max(refresh_err, float((g - w.cpu()).abs().max()))
        if float(excess.max()) > 0:
            raise AssertionError(f"cross-rank refresher off the one-process one at {k}")
    out["refresh_max_abs_err"] = refresh_err
    print(
        f"dp cross-rank BNRefresher ({DP_RANKS} x {DP_STAT_BATCHES} batches of "
        f"{DP_LOCAL_BATCH}) vs the one-process refresher over all of them: max |d| "
        f"{refresh_err:.2e} (tolerance {DP_REFRESH_ATOL:g} + {DP_REFRESH_RTOL:g} * |v|)"
    )

    # Serving: every rank's gathered outputs against the one-rank paths at
    # the ranks' per-call batch, bit for bit.
    config = container.get_config()
    loaded = LoadedModel("unet", base, config)
    for tie in ("fast", "exact"):
        seg = VolumeSegmenter(
            loaded, config, batch_size=DP_LOCAL_BATCH, minpath_tie_parity=tie, device="cuda"
        )
        want_seg = seg.segment_volume(volume)
        pipe = make_fused_pipeline(
            fold_batchnorm(base), container.get_preprocess_input_fn(),
            minpath_tie_parity=tie, return_maps=False, device="cuda",
        )
        want_fold = run_volume(pipe, volume, DP_LOCAL_BATCH)
        for rank in ranks:
            for name, want in ((f"seg_{tie}", want_seg), (f"folded_{tie}", want_fold)):
                for part, a, b in zip(("labels", "rows"), rank[name], want):
                    if not np.array_equal(a, b):
                        raise AssertionError(f"rank {rank['rank']} {name} {part} differ")
        check_rows(tie, ranks[0][f"seg_{tie}"][0], ranks[0][f"seg_{tie}"][1])
        check_rows(tie, ranks[0][f"folded_{tie}"][0], ranks[0][f"folded_{tie}"][1])
    b2 = [r["b2_launches"]["minpath_dp_s2d"] for r in ranks]
    b1 = [r["b1_launches"]["minpath_dp"] for r in ranks]
    if min(b1) < 1 or min(b2) < 1:
        raise AssertionError(f"a rank served without its kernel: B1 {b1}, B2 {b2}")
    for r in ranks:
        if r["b2_launches"]["minpath_dp"] or r["b1_launches"]["minpath_dp_s2d"]:
            raise AssertionError(f"rank {r['rank']} launched the other min-path kernel")
        if r["b2_launches"]["s2d_enc_pair"] or r["b1_launches"]["s2d_enc_pair"]:
            raise AssertionError(f"rank {r['rank']} launched the encoder-pair kernel")
    out.update(b1_launches_per_rank=b1, b2_launches_per_rank=b2)
    print(
        f"dp serving over {DP_RANKS} ranks ({VOLUME} B-scans, batch {BATCH}, "
        f"{DP_LOCAL_BATCH} per rank and call): VolumeSegmenter(mesh=) (s2d) and the folded "
        f"make_fused_pipeline(mesh=), both tie modes, labels and rows equal to the one-rank "
        f"paths at batch {DP_LOCAL_BATCH} on every rank; B2 launches per rank {b2}, B1 {b1}"
    )
    return out


def phase_dp_path(rng, model, volume: np.ndarray, seed: int) -> dict:
    """The data-parallel slice: a world of one over NCCL at full width,
    then two ranks that share the card over gloo."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"world1": dp_world_of_one(rng, model, seed)}
    torch.cuda.empty_cache()
    out["two_ranks"] = dp_two_ranks(rng, model, volume, seed)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


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


def enc_pair_bound_ms(b, nh, nw, cin4, c4) -> dict:
    """Least time for the encoder pair on these shapes: the dense
    block-space FLOPs (2 per multiply-add, both convs, y1 with its
    (nh+1, nw+1) shifted grid) against the bytes of x, the weights and
    biases read once and y2 and pooled written once over HBM bandwidth.
    On the route the kernel takes, the tensor cores in 3xTF32, each
    multiply-add is three TF32 products at the TF32 rate; on the float32
    CUDA cores, one at the float32 rate. Returns ``{"ms", "by", "flop",
    "fp32_ms", "fp32_by"}``, ``ms`` and ``by`` for the tensor cores."""
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
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3

    def bound(t_ops):
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    ms, by = bound(3 * flop / TF32_FLOPS_PER_S * 1e3)
    fp32_ms, fp32_by = bound(flop / FP32_FLOPS_PER_S * 1e3)
    return {"ms": ms, "by": by, "flop": flop, "fp32_ms": fp32_ms, "fp32_by": fp32_by}


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
        enc_pair_tile,
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
            # B1 on the folded path's maps. The plain versions take seconds
            # a call (the DP column by column in PyTorch): one call each.
            out[f"b1_{tie}_ms"] = time_cuda(
                lambda: delineate_cuda(maps_t, tie_parity=tie), iters=10
            )
            out[f"b1_plain_{tie}_ms"] = time_cuda(
                lambda: delineate_reference(maps_t, tie_parity=tie),
                iters=1, reps=1, warmup=0,
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
                iters=1, reps=1, warmup=0,
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
        out["b3_tile"] = enc_pair_tile(shape[4])
        bound = enc_pair_bound_ms(*shape)
        out["b3_bound_ms"], out["b3_bound_by"] = bound["ms"], bound["by"]
        out["b3_bound_fp32_ms"] = bound["fp32_ms"]
        out["b3_bound_fp32_by"] = bound["fp32_by"]
        out["b3_tflops"] = bound["flop"] / 1e9 / out["b3_ms"]
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
    predict = phase_predict_path(model, rng, volume, s2d["labels"])
    times = phase_times(model, s2d, folded, fused, parity_pair["flagship_args"])
    times.update(predict_path_times(predict, volume))
    train = phase_train_path(rng, args.seed)
    deeplab = phase_deeplab_path(rng, args.seed, volume)
    export = phase_export_path(model, args.seed, volume)
    dp = phase_dp_path(rng, model, volume, args.seed)

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
            f"[{card}] predict path (run_pipeline, batch {BATCH} x {H}x{W}, {tie} ties), "
            f"per image: predict {times[f'staged_predict_{tie}_ms_per_image']:.3f} ms, "
            f"convert {times[f'staged_convert_{tie}_ms_per_image']:.3f} ms, graph "
            f"{times[f'staged_graph_{tie}_ms_per_image']:.3f} ms; the whole call on "
            f"{VOLUME} B-scans {times[f'staged_run_pipeline_{tie}_s']:.3f} s = "
            f"{VOLUME / times[f'staged_run_pipeline_{tie}_s']:.1f} B-scans/s"
        )
    copy_mib = times["host_copy_bytes_per_batch"] / 2**20
    print(
        f"[{card}] predict path host copy per batch of {BATCH} ({copy_mib:.1f} MiB, "
        f"categorical {times['host_copy_categorical_bytes'] / 2**20:.1f} MiB): "
        f"{times['host_copy_ms_per_batch']:.3f} ms = "
        f"{times['host_copy_bytes_per_batch'] / times['host_copy_ms_per_batch'] / 1e6:.2f} GB/s"
    )
    print(
        f"[{card}] delineate_float (plain PyTorch) at "
        f"{predict['delineate_float_shape']}: {predict['delineate_float_ms']:.3f} ms"
    )
    for tie in ("fast", "exact"):
        print(
            f"[{card}] minpath {tie} at {N_MAPS}x{W}x{H}: B1 "
            f"{times[f'b1_{tie}_ms']:.4f} ms = {times[f'b1_{tie}_ms'] / W * 1e3:.3f} "
            f"us/column (plain {times[f'b1_plain_{tie}_ms']:.1f}"
            f" ms), B2 {times[f'b2_{tie}_ms']:.4f} ms = "
            f"{times[f'b2_{tie}_ms'] / W * 1e3:.3f} us/column (plain "
            f"{times[f'b2_plain_{tie}_ms']:.1f} ms, transpose + B1 "
            f"{times[f'b2_yardstick_{tie}_ms']:.4f} ms), bound "
            f"{times[f'minpath_bound_{tie}_ms']:.5f} ms "
            f"({times[f'minpath_bound_{tie}_by']})"
        )
    print(
        f"[{card}] s2d_enc_pair at x {times['b3_shape'][:4]}, 4C "
        f"{times['b3_shape'][4]} (tile {times['b3_tile']}): kernel "
        f"{times['b3_ms']:.3f} ms ({times['b3_tflops']:.2f} TFLOP/s), plain "
        f"version (the unfused cuDNN chain) {times['b3_plain_ms']:.3f} ms, bound "
        f"{times['b3_bound_ms']:.3f} ms on the tensor cores in 3xTF32 "
        f"({times['b3_bound_by']}), {times['b3_bound_fp32_ms']:.3f} ms on the "
        f"float32 CUDA cores ({times['b3_bound_fp32_by']})"
    )
    print(
        f"[{card}] train step (batch {BATCH} x {H}x{W}, start_neurons 32, float32, TF32 "
        f"off, Adam, focal+Dice): {train['step_ms']:.3f} ms/step = "
        f"{train['bscans_per_s']:.2f} B-scans/s; {train['gflop_per_step']:.1f} GFLOP/step, "
        f"{train['tflops']:.2f} TFLOP/s (float32 bound {train['bound_ms']:.3f} ms); split "
        f"forward with loss and metric {train['forward_ms']:.3f} ms, backward "
        f"{train['backward_ms']:.3f} ms, optimizer {train['optimizer_ms']:.3f} ms; peak "
        f"memory {train['peak_mib']:.1f} MiB"
    )
    print(
        f"[{card}] profiled train step: wall {train['profile_profiled_wall_ms_per_batch']:.3f} "
        f"ms/step, device {train['profile_device_ms_per_batch']:.3f} ms/step, busy share "
        + ("not measured" if train["profile_device_busy_share"] is None
           else f"{train['profile_device_busy_share']:.4f}")
    )
    for name, ms in train["profile_top_kernels_ms_per_batch"]:
        print(f"  {ms:9.3f} ms/step  {name[:100]}")
    print(
        f"[{card}] train loop with DataGenerator and pinned uploads: {train['loop_steps']} "
        f"steps in {train['loop_s']:.3f} s = {train['loop_bscans_per_s']:.2f} B-scans/s; "
        f"eval step {train['eval_ms']:.3f} ms/batch; one BNRefresher pass over "
        f"{TRAIN_IMAGES} B-scans {train['bn_refresh_ms']:.3f} ms"
    )
    dt, dtr, dck = deeplab["times"], deeplab["train"], deeplab["step_check"]
    for tie in ("fast", "exact"):
        print(
            f"[{card}] deeplab folded pipeline batch {BATCH} x {H}x{W}x3, {tie} ties: "
            f"{dt[f'pipeline_{tie}_ms']:.3f} ms/batch, "
            f"{dt[f'pipeline_{tie}_bscans_per_s']:.1f} B-scans/s"
        )
    print(
        f"[{card}] deeplab folded forward (batch {BATCH}): {dt['forward_ms']:.3f} ms, "
        f"{dt['forward_gflop']:.1f} GFLOP, {dt['forward_tflops']:.2f} TFLOP/s (float32 bound "
        f"{dt['forward_bound_ms']:.3f} ms); the pipeline {dt['pipeline_fast_tflops']:.2f} "
        f"TFLOP/s; profiled wall {dt['profiled_wall_ms_per_batch']:.3f} ms/batch, device "
        f"{dt['device_ms_per_batch']:.3f} ms/batch, busy share "
        + ("not measured" if dt["device_busy_share"] is None else f"{dt['device_busy_share']:.4f}")
    )
    for name, ms in dt["top_kernels_ms_per_batch"]:
        print(f"  {ms:9.3f} ms/batch  {name[:100]}")
    print(
        f"[{card}] deeplab train step (batch {BATCH} x {H}x{W}x3, float32, TF32 off, Adam, "
        f"focal+Dice): {dtr['step_ms']:.3f} ms/step = {dtr['bscans_per_s']:.2f} B-scans/s; "
        f"{dtr['gflop_per_step']:.1f} GFLOP/step, {dtr['tflops']:.2f} TFLOP/s (float32 bound "
        f"{dtr['bound_ms']:.3f} ms); split forward with loss and metric "
        f"{dtr['forward_ms']:.3f} ms, backward {dtr['backward_ms']:.3f} ms, optimizer "
        f"{dtr['optimizer_ms']:.3f} ms; peak memory {dtr['peak_mib']:.1f} MiB; eval step "
        f"{dtr['eval_ms']:.3f} ms; BNRefresher over {2 * BATCH} B-scans "
        f"{dtr['bn_refresh_ms']:.3f} ms; loop {dtr['loop_bscans_per_s']:.2f} B-scans/s"
    )
    print(
        f"[{card}] deeplab gradients vs the replaying float64 step: card "
        f"{dck['grad_card_worst_rel']:.2e}, CPU float32 {dck['grad_cpu_worst_rel']:.2e} of "
        f"the worst tensor's max ({dck['grad_worst_tensor']}); the phase "
        f"{deeplab['phase_s']:.1f} s"
    )
    export_launches = {"minpath_dp": 0, "minpath_dp_s2d": 0}
    for name, res in export.items():
        if name != "phase_s":
            export_launches[res["kernel"]] += res["launches"]
            print(
                f"[{card}] export_path {name}: artifact {res['artifact_ms_per_batch']:.3f} "
                f"ms/batch, eager {res['eager_ms_per_batch']:.3f} ms/batch (batch {BATCH} x "
                f"{H}x{W}, {res['tie']} ties, DeviceStopwatch median of {EXPORT_TIMED}); "
                f"cli export {res['export_s']:.2f} s, load {res['load_s']:.3f} s"
            )
    print(f"[{card}] export_path phase {export['phase_s']:.1f} s")
    minpath_src = "oct_image_segmentation_models_torch/csrc/minpath.cu"
    tpu_minpath = "oct_image_segmentation_models_tpu/ops/minpath_pallas.py"
    kernels = []
    for name, launches, err, key, replaces in (
        (
            "minpath_dp",
            folded["launches"] + predict["launches"] + train["launches"]["minpath_dp"]
            + deeplab["launches"] + sum(dp["two_ranks"]["b1_launches_per_rank"])
            + export_launches["minpath_dp"],
            parity["max_abs_err"],
            "b1",
            f"{tpu_minpath}:487",
        ),
        (
            "minpath_dp_s2d",
            s2d["launches"] + train["launches"]["minpath_dp_s2d"]
            + sum(dp["two_ranks"]["b2_launches_per_rank"])
            + export_launches["minpath_dp_s2d"],
            parity_s2d["max_abs_err"],
            "b2",
            f"{tpu_minpath}:533",
        ),
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
            us_per_column=times[f"{key}_fast_ms"] / W * 1e3,
            us_per_column_exact=times[f"{key}_exact_ms"] / W * 1e3,
        )
        if key == "b1":
            line["launches_folded_path"] = folded["launches"]
            line["launches_predict_path"] = predict["launches"]
            line["predict_path_store_launches"] = predict["store_launches"]
            line["launches_train_path"] = train["launches"]["minpath_dp"]
            line["launches_deeplab_path"] = deeplab["launches"]
            line["launches_dp_path_per_rank"] = dp["two_ranks"]["b1_launches_per_rank"]
            line["launches_export_path"] = export_launches["minpath_dp"]
        if key == "b2":
            line["launches_s2d_path"] = s2d["launches"]
            line["launches_train_path"] = train["launches"]["minpath_dp_s2d"]
            line["launches_dp_path_per_rank"] = dp["two_ranks"]["b2_launches_per_rank"]
            line["launches_export_path"] = export_launches["minpath_dp_s2d"]
            line["transpose_then_b1_ms"] = times["b2_yardstick_fast_ms"]
            line["transpose_then_b1_ms_exact"] = times["b2_yardstick_exact_ms"]
        kernels.append(line)
    b3_line = kernel_line(
        "s2d_enc_pair",
        "oct_image_segmentation_models_torch/csrc/s2d_enc_pair.cu",
        "oct_image_segmentation_models_tpu/ops/s2d_pallas.py:153",
        fused["launches"], parity_pair["max_abs_err"], times["b3_ms"],
        times["b3_plain_ms"], times["b3_bound_ms"], times["b3_bound_by"],
        times["b3_plain_ms"],
    )
    b3_line.update(
        bound_ms_fp32_cuda_cores=times["b3_bound_fp32_ms"],
        bound_by_fp32_cuda_cores=times["b3_bound_fp32_by"],
        tile=times["b3_tile"],
    )
    kernels.append(b3_line)
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
            "predict_path": {
                k: v for k, v in predict.items()
                if k not in ("loaded", "config", "preprocess")
            },
            "times": times,
            "train_path": train,
            "deeplab_path": deeplab,
            "export_path": export,
            "dp_path": dp,
            "kernels": kernels,
            "total_s": time.perf_counter() - t_start,
        }
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    w1, two = dp["world1"], dp["two_ranks"]
    print(
        f"[{card}] dp path: world of one (NCCL) train step {w1['ddp_world1_step_ms']:.3f} ms "
        f"with DDP, {w1['one_device_step_ms']:.3f} ms without; two ranks on the card (gloo): "
        f"{two['ranks_wall_s']:.1f} s for both ranks' work, spawn included; the phase "
        f"{dp['phase_s']:.1f} s"
    )
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"dp": {
        "world1_ddp_step_ms": w1["ddp_world1_step_ms"],
        "world1_one_device_step_ms": w1["one_device_step_ms"],
        "world1_param_max_abs_err": w1["param"],
        "world1_stat_max_abs_err": w1["stat"],
        "world1_loss_max_abs_err": w1["loss_max_abs_err"],
        "two_rank_loss_rel_err": two["step_loss_rel_err"],
        "two_rank_metric_rel_err": two["step_metric_rel_err"],
        "two_rank_grad_worst_of_allowance": two["step_grad_worst_of_allowance"],
        "two_rank_stat_max_abs_err": two["step_stat_max_abs_err"],
        "two_rank_refresh_max_abs_err": two["refresh_max_abs_err"],
        "two_rank_serving_bit_equal": True,
        "b1_launches_per_rank": two["b1_launches_per_rank"],
        "b2_launches_per_rank": two["b2_launches_per_rank"],
        "two_rank_wall_s": two["ranks_wall_s"],
        "phase_s": dp["phase_s"],
    }}))
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
