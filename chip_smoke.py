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
   - the train path, the device part of ``train_model``, through the
     forward that ``train_forward_impl="auto"`` resolves to
     (``training.resolve_train_forward``: the s2d training forward of
     ``ops/s2d_train.py`` for this U-Net, as in JAX; the phase prints it
     and fails on another): first one train step at batch 2 of 128x256 on
     the card and on the CPU from the same weights, batch and dropout
     mask, through that forward and through the parity module (loss and
     BN statistics within stated tolerances; per-tensor gradients against
     the CPU float64 step that replays the card step's ReLU gates and
     max-pool picks, the s2d forward's recorded by ``s2d_functional``,
     whose count is printed and must not be 0); then, from fresh weights,
     the port's ``DataGenerator`` feeds ``train_step`` (focal + Dice, Adam
     1e-3, float32) for 120 steps at batch 8 of 512x1024, the parity step
     timed beside it in turns, ``eval_step`` runs on a validation batch
     and ``BNRefresher`` recomputes the statistics, all through that
     forward. The loss must fall below the first step's and the statistics
     be finite with var > 0. The trained weights are then served through
     the folded path (B1) and the s2d path (B2) on held-out B-scans, rows
     against the plain min-path, and their dice printed;
   - the s2d training path (``s2d_train_path``, ``ops/s2d_train.py``), run
     after the train path: one float64 step of ``S2DTrainForward`` on the
     card at batch 2 of 128x256 against one parity step from the same
     weights and dropout mask (a float64 cross-entropy; loss within
     ``S2D_LOSS_RTOL``, every gradient within ``S2D_GRAD_TOL`` of its
     tensor's max, statistics within ``S2D_STAT_ATOL``); the eval-mode s2d
     forward against the parity forward (``S2D_EVAL64_ATOL`` in float64,
     ``PROB_ATOL`` in float32);
     ``S2D_TRAIN_STEPS`` float32 steps of the s2d forward through
     ``make_train_step`` at batch 8 of 512x1024 (the loss must fall); the
     s2d and the parity step timed in turns from the same state (ms,
     split by ``on_phase``, GFLOP, peak memory); precise BN through
     ``BNRefresher(S2DTrainForward)``; the trained weights served through
     ``VolumeSegmenter``'s s2d default in both tie modes, rows against
     the plain min-path, B2 launched and no other kernel in the phase;
     ``S2D_BF16_STEPS`` bfloat16 s2d steps and as many bfloat16 parity
     steps, timed;
   - the data-parallel path (``parallel/``), after ``torch.cuda.empty_cache()``:
     every step through the forward ``"auto"`` resolves to (the s2d
     training forward; DDP over it), as ``train_model`` trains;
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
     at the ranks' per-call batch of 4, bit for bit. The same ranks run
     ``impl="spmd"``, the one-device step on the global batch: one float64
     step at 128x256, local batch 2, against the one-device step on the
     4 rows (the ``S2D_*`` bounds), one float32 step at full width, local
     batch 4, against the one-device step on the 8 rows (loss and
     statistics within ``DP_SPMD_RTOL``), both ranks' states bit-equal,
     then ``DP_TIMED`` spmd steps timed (two ranks share one card over
     gloo: no scaling number). Each rank counts its own kernel launches.
   - the DeepLabV3+ path (``deeplab_path``), run before the data-parallel
     path from its own random stream, on DeepLabV3+ (the ResNet50
     backbone to conv4, DSPP, decoder, 4 classes) with seeded random
     weights and the gray B-scans repeated
     over 3 channels: the eval-mode forward, plain and BN-folded, on the
     card against the CPU at 2 x 128x256 (``PROB_ATOL``, argmax agreement);
     the 20-B-scan volume at 512x1024 through the folded
     ``make_fused_pipeline`` and ``VolumeSegmenter`` in both tie modes,
     rows against the plain min-path, B1 launched and B2 and B3 not; one
     train step at batch 2 of 64x128 on the card and on the CPU, each
     step's gradients against the CPU float64 step that replays its ReLU
     gates and max-pool picks (the card held to the larger of
     ``STEP_GRAD_RTOL`` and ``DL_GRAD_CPU_FACTOR`` times the CPU float32
     step's own error, per tensor; the factor set from the spread that
     ``tools/torch_deeplab_gate_probe.py`` measured over seeds); the train
     step at batch 8 of 512x1024 from the ``DataGenerator`` timed on a
     copy of the weights, then 30 train steps (the loss must fall), the
     eval step and ``BNRefresher`` under deterministic algorithms, from a
     stream of their own, so that the trained weights, served through B1
     here and in bfloat16 by the bf16 path, are one set per seed. Its
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
   - the bfloat16 path (``bf16_path``), run after the export path, on
     the weights that the train path and the DeepLabV3+ path trained: the
     bfloat16 s2d U-Net and folded DeepLabV3+ forwards on the card against
     the CPU at 2 x 128x256 (``BF16_PROB_ATOL``, argmax agreement); the
     20-B-scan volume through ``VolumeSegmenter(compute_dtype="bfloat16")``
     in both tie modes, the U-Net through B2 and the DeepLab through B1,
     only that kernel launched, rows against the plain min-path; the same
     weights' bfloat16 labels and rows against their float32 serving
     within the reference's budget (agreement > 0.995, rows MAE < 0.05
     px); each pipeline's ms per batch, B-scans/s, the forward's TFLOP/s
     against 989 TFLOP/s dense bf16, and the busy share; one bfloat16 train
     step at batch 2 of 128x256 on the card against the CPU (and both
     against the CPU float64 step), through the forward ``"auto"``
     resolves to (s2d) and through the parity module; ``BF16_TRAIN_STEPS``
     bfloat16 train steps at batch 8 of 512x1024 through the forward
     ``"auto"`` resolves to (the loss must fall) with the step's ms,
     split, FLOPs and peak memory, the parity step timed beside it in
     turns; and one bfloat16 s2d export
     artifact, traced in-process, serving the volume bit-equal to eager
     bfloat16 serving with 3 B2 launches.
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

The workflow path (``workflow_path``), run after the data-parallel path,
drives the file-backed entry points as a user calls them, every HDF5 file
through the port's own layer (``common/h5.py``; the card's machine has
neither h5py nor matplotlib, and the phase fails if h5py was imported): a
reference-schema dataset (48 train, 16 validation and 16 test layered
B-scans at 512x1024, about 84 MB) written and read back bit for bit, the
read rate printed; ``train_model`` with its defaults (the s2d forward that
``"auto"`` resolves to, which the phase checks, HDF5 checkpoints, precise
BN) for 2 epochs at batch 8, its seconds per epoch beside the train
path's step; every HDF5 file of its tree read back (``stats_epoch02.hdf5``
with 2 finite epochs, ``training_params.hdf5`` with the appended
``bn_precise_stats_applied``); ``model_final.hdf5`` through
``load_model_and_config``, bit-equal to the module ``train_model`` saved,
served through ``VolumeSegmenter`` (B2, fast ties) and ``predict``
(``png_images=False``, graph search, B1) in both tie modes, every file
read back equal to ``run_pipeline`` in memory and every path's rows equal
to the plain min-path on maps rebuilt from its labels; ``evaluate_model``
(graph search, B1) with finite Dice in [0, 1] and the per-image rows of
``predict``. Checkpoint write and read ms, ``predict`` and
``evaluate_model`` wall seconds, their host writes on the default worker
pool. The export path reads no HDF5: directory
checkpoints and the ``torch.export`` artifact need none.

It prints one ``{"bf16": {...}}`` line with the bfloat16 path's results,
one ``{"s2d_train": {...}}`` line with the s2d training path's, one
``{"train_default": {...}}`` line with the default (``"auto"``) train
steps' forward, times and gradient gates,
one ``{"dp": {...}}`` line with the data-parallel path's results, one
``{"workflow": {...}}`` line with the workflow path's, one
``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits with code 2 and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# cuBLAS sums in a fixed order only with a fixed workspace, read when its
# first handle is made: the matmuls of the DeepLab's deterministic
# training (``DeterministicResize``'s backward) need it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


def unet_container(h: int = H, w: int = W, **kw):
    """The bench's U-Net container (start_neurons=32, pool_layers=4,
    conv_layers=2) at ``h`` x ``w``."""
    from oct_image_segmentation_models_torch.models import get_model_class

    return get_model_class("unet")(
        input_channels=1, num_classes=NUM_CLASSES, image_height=h, image_width=w,
        start_neurons=32, pool_layers=4, conv_layers=2, **kw,
    )


def build_unet(seed: int):
    container = unet_container()
    module = container.build_model(
        generator=torch.Generator().manual_seed(seed), device="cuda"
    )
    return container, module


def auto_forward(module, h: int = H, w: int = W):
    """``(forward, kind)``: the forward that ``train_model`` trains the
    bench's U-Net ``module`` through at ``h`` x ``w`` under
    ``train_forward_impl="auto"`` (``training.resolve_train_forward``)."""
    from oct_image_segmentation_models_torch.training.training import resolve_train_forward

    return resolve_train_forward(module, unet_container(h, w).get_config(), h, w, "auto")


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
# Two forwards' steps timed in turns: TURN_RUNS runs of TURN_STEPS steps
# each, every forward's run in turn; its time the fastest run's.
TURN_STEPS = 5
TURN_RUNS = 2
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

    def phase_max_pool(self, x):
        """The s2d forward's max over the 4 phase groups of an NCHW ``x``
        (``ops/s2d_unet.py::_phase_max_pool_nchw``); its picks are the
        phase each output takes."""
        from oct_image_segmentation_models_torch.ops.s2d_unet import _phase_max_pool_nchw

        b, c4, h, w = x.shape
        phases = x.reshape(b, 4, c4 // 4, h, w)
        if self._picks is not None:
            idx = next(self._picks).to(x.device)
            return torch.gather(phases, 1, idx[:, None]).squeeze(1)
        self.picks.append(phases.argmax(dim=1).cpu())
        return _phase_max_pool_nchw(x)


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


@contextlib.contextmanager
def s2d_functional(recorder):
    """``ops/s2d_train.py`` calls ``recorder`` for its ``F.relu`` and
    ``F.max_pool2d`` and for its phase max-pool inside."""
    from oct_image_segmentation_models_torch.ops import s2d_train

    saved = s2d_train.F, s2d_train._phase_max_pool_nchw
    s2d_train.F, s2d_train._phase_max_pool_nchw = recorder, recorder.phase_max_pool
    try:
        yield recorder
    finally:
        s2d_train.F, s2d_train._phase_max_pool_nchw = saved


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
    under the global TF32 defaults (the step sets its own precision),
    through the forward that ``train_forward_impl="auto"`` resolves to
    (the s2d training forward) and through the parity module. The
    gradients of each step are held against the CPU float64 step that
    takes that step's ReLU gates and max-pool picks (the s2d forward's
    phase picks included)."""
    card = check_size_unet(seed + 1)
    _, kind = auto_forward(card, CHECK_H, CHECK_W)
    print(f"train step check: train_forward_impl='auto' resolved to {kind} at {CHECK_H}x{CHECK_W}")
    if kind != "s2d":
        raise AssertionError(f"'auto' resolved to {kind} for the bench's U-Net")
    initial = card.cpu()
    images, labels = layered_dataset(rng, CHECK_BATCH, CHECK_H, CHECK_W, NUM_CLASSES)
    x = torch.from_numpy(images.astype(np.float32) / 255.0)
    y = torch.from_numpy(labels)
    return {"auto_kind": kind, **{k: step_gate(k, initial, x, y, seed) for k in (kind, "parity")}}


def step_gate(kind: str, initial, x, y, seed: int) -> dict:
    """:func:`check_train_step_card_vs_cpu` for one forward, ``kind``
    "s2d" (``S2DTrainForward``, whose ReLUs and pools ``s2d_functional``
    records) or "parity" (the module, ``unet_functional``)."""
    from oct_image_segmentation_models_torch.models import unet as unet_module
    from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward

    functional = s2d_functional if kind == "s2d" else unet_functional
    masks = {}

    def shared_mask(t, generator):
        if "mask" not in masks:
            draw = torch.rand(t.shape, generator=torch.Generator().manual_seed(seed))
            masks["mask"] = draw < 1.0 - unet_module.DROPOUT_RATE
        return masks["mask"].to(t.device)

    def run(module, recorder):
        dev = next(module.parameters()).device
        forward = S2DTrainForward(module) if kind == "s2d" else module
        state, step, _ = _train_objects(forward, seed)
        with functional(recorder):
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
        l_card, m_card, g_card, s_card = run(copy.deepcopy(initial).cuda(), rec["card"])
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
    # What the card step recorded: ReLUs and pools, and their gates and picks.
    recorded = {
        "relus": len(rec["card"].gates), "gates": sum(g.numel() for g in rec["card"].gates),
        "pools": len(rec["card"].picks), "picks": sum(p.numel() for p in rec["card"].picks),
    }
    print(
        f"train step card vs CPU ({kind} forward, start_neurons 32, batch {CHECK_BATCH} x "
        f"{CHECK_H}x{CHECK_W}, float32): loss {l_card:.6f} / {l_cpu:.6f} (rel {loss_err:.2e}, "
        f"tolerance {STEP_LOSS_RTOL:g}), metric {m_card:.6f} / {m_cpu:.6f}, BN statistics max "
        f"|diff| {stat_err:.2e} (tolerance {STEP_STAT_ATOL:g}), pre-BN conv bias gradients "
        f"{zero_grad / gmax:.2e} of max |g| (bound {ZERO_GRAD_SHARE:g})"
    )
    print(
        f"  recorded on the card from {'ops/s2d_train.py' if kind == 's2d' else 'models/unet.py'}"
        f": {recorded['relus']} ReLUs ({recorded['gates']} gates), {recorded['pools']} max-pools "
        f"({recorded['picks']} picks), replayed by the float64 steps"
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
    if not (recorded["gates"] and recorded["picks"]):
        raise AssertionError(f"the {kind} step recorded no gates or picks: {recorded}")
    if not (np.isfinite(l_card) and loss_err <= STEP_LOSS_RTOL):
        raise AssertionError(f"card {kind} train-step loss {l_card} off the CPU's {l_cpu}")
    if card_worst > 1 or cpu_worst > 1 or zero_grad > ZERO_GRAD_SHARE * gmax:
        raise AssertionError(
            f"{kind} gradients off float64 with the same gates: card {card_worst}, CPU "
            f"{cpu_worst} of the allowance; zero share {zero_grad / gmax}"
        )
    if stat_err > STEP_STAT_ATOL:
        raise AssertionError(f"card {kind} BN statistics off the CPU's by {stat_err}")
    return {
        "recorded": recorded,
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
    """The training slice's device part at full width, through the
    forward that ``train_forward_impl="auto"`` resolves to (the s2d
    training forward, as ``train_model`` trains): the port's
    DataGenerator feeds ``train_step`` (focal + Dice, Adam 1e-3, float32)
    for ``TRAIN_STEPS`` steps at batch 8 of 512x1024, the parity step
    timed beside it in turns, then ``eval_step`` and the precise-BN
    ``BNRefresher``; the trained weights are served through the folded
    path (B1) and the s2d path (B2)."""
    from oct_image_segmentation_models_torch.common.data_generator import DataGenerator
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.parallel.train_step import load_batch_stats
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    out = {"step_check": check_train_step_card_vs_cpu(rng, seed)}
    container, module = build_unet(seed)
    forward, kind = auto_forward(module)
    out["auto_kind"] = kind
    print(f"train path: train_forward_impl='auto' resolved to {kind} at {H}x{W}")
    if kind != "s2d":
        raise AssertionError(f"'auto' resolved to {kind} for the bench's U-Net")
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
    state, step, evaluate = _train_objects(forward, seed)
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

    # The parity step beside it, timed in turns from the same weights.
    parity_module = copy.deepcopy(module)
    p_state, p_step, _ = _train_objects(parity_module, seed)
    ms, _ = time_in_turns(
        {kind: (state, step), "parity": (p_state, p_step)},
        fixed[TRAIN_WARMUP:TRAIN_WARMUP + TURN_STEPS], generator,
    )
    del parity_module, p_state, p_step
    out["turns_step_ms"] = {name: min(v) for name, v in ms.items()}
    out["turns_step_ms_runs"] = ms
    print(
        f"train path: the {kind} step {out['turns_step_ms'][kind]:.3f} ms against the parity "
        f"step's {out['turns_step_ms']['parity']:.3f} ms, timed in turns (runs "
        + "; ".join(f"{n} {', '.join(f'{v:.3f}' for v in r)}" for n, r in ms.items())
        + ")"
    )

    # Training on through the generator, host batches and uploads included.
    loop_steps = TRAIN_STEPS - state.step
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    for _ in range(loop_steps):
        x, y = next(stream)
        _, loss, _ = step(state, x, y, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    out["loop_s"] = time.perf_counter() - t_host
    out["loop_steps"] = loop_steps
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
    refresher = BNRefresher(forward)
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
    out["_trained"] = (container, module)  # for the bfloat16 path, not printed
    return out


# --- the space-to-depth training path --------------------------------------

S2D_TRAIN_STEPS = 30
S2D_BF16_STEPS = 8
# s2d against parity in float64 (one step, the same weights and dropout
# mask, a float64 cross-entropy): the transform is exact algebra, so only
# rounding parts them; float64 keeps flipped ReLU gates out of the check.
# Gradients per tensor within S2D_GRAD_TOL of its max (the pre-BN conv
# biases, whose exact gradient is 0, of the largest gradient's).
S2D_LOSS_RTOL = 1e-10
S2D_GRAD_TOL = 1e-9
S2D_STAT_ATOL = 1e-10
# The eval-mode s2d training forward against the parity forward at full
# width: in float64 within S2D_EVAL64_ATOL (the same function); in float32
# within PROB_ATOL (two float32 forwards summed in another order: 3.0e-5
# on the card, where each sits 5.1e-5 and 3.7e-5 off its float64 forward).
S2D_EVAL64_ATOL = 1e-10


def xent64(labels, probs):
    """Cross-entropy in the probabilities' dtype: the registry's losses
    compute in float32, whose rounding a float64 check would read."""
    onehot = torch.nn.functional.one_hot(labels[..., 0].long(), probs.shape[-1])
    return -(onehot * torch.log(probs)).sum(-1).mean()


def step64(forward, module, x, y, seed: int, mesh=None, impl: str = "auto"):
    """One Adam step of ``forward`` (over ``module``'s parameters) with
    :func:`xent64`: ``(loss, gradients, running statistics, state)`` on the
    CPU. The dropout generator is seeded with ``seed``."""
    from oct_image_segmentation_models_torch.parallel.train_step import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    state = create_train_state(module, build_optimizer("adam", {}), mesh)
    step = make_train_step(forward, xent64, xent64, mesh, impl)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    _, loss, _ = step(state, x, y, gen)
    grads = {k: p.grad.detach().cpu() for k, p in module.named_parameters()}
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    return float(loss), grads, {k: v for k, v in sd.items() if "running" in k}, sd


def compare64(got, want) -> dict:
    """Two float64 steps (``step64``'s loss, gradients, statistics):
    the loss's relative error, each gradient's error over its scale, the
    statistics' largest error."""
    loss_rel = abs(got[0] - want[0]) / abs(want[0])
    largest = max(float(g.abs().max()) for g in want[1].values())
    worst, worst_key = 0.0, None
    for k, g in want[1].items():
        scale = largest if _pre_bn_bias(k) else float(g.abs().max())
        err = float((got[1][k] - g).abs().max()) / scale
        if err >= worst:
            worst, worst_key = err, k
    stat = max(float((got[2][k] - v).abs().max()) for k, v in want[2].items())
    return {"loss_rel": loss_rel, "grad_worst": worst, "grad_worst_tensor": worst_key,
            "stat_max_abs": stat}


def check64(res: dict, what: str) -> None:
    if not (
        res["loss_rel"] <= S2D_LOSS_RTOL and res["grad_worst"] <= S2D_GRAD_TOL
        and res["stat_max_abs"] <= S2D_STAT_ATOL
    ):
        raise AssertionError(f"{what}: float64 check failed: {res}")


def check_size_unet(seed: int, device="cuda"):
    """The bench's U-Net at the check size (``CHECK_H`` x ``CHECK_W``)."""
    return unet_container(CHECK_H, CHECK_W).build_model(
        generator=torch.Generator().manual_seed(seed), device=device
    )


def time_in_turns(runs: dict, batches, generator) -> tuple:
    """``({name: [ms per step of each run]}, {name: peak MiB})`` of the
    ``(state, step)`` pairs in ``runs``, timed in turns: ``TURN_RUNS``
    rounds, each of which times every pair once over ``batches``."""
    ms, peak = {name: [] for name in runs}, {}
    for _ in range(TURN_RUNS):
        for name, (state, step) in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms[name].append(timed_steps(step, state, batches, generator))
            peak[name] = torch.cuda.max_memory_allocated() / 2**20
    return ms, peak


def timed_steps(step, state, batches, generator) -> float:
    """ms per step of ``len(batches)`` steps back to back (CUDA events)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for x, y in batches:
        step(state, x, y, generator)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / len(batches)


def step_split(step, state, batches, generator) -> dict:
    """The median ms of each phase of the step ("forward" with the loss
    and metric, "backward", "optimizer"), from events the step's
    ``on_phase`` hook records."""
    phases = ("forward", "backward", "optimizer")
    splits = {name: [] for name in phases}
    for x, y in batches:
        ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + phases}
        ev["start"].record()
        step(state, x, y, generator, on_phase=lambda name: ev[name].record())
        ev["optimizer"].synchronize()
        for a, b in zip(("start",) + phases, phases):
            splits[b].append(ev[a].elapsed_time(ev[b]))
    return {f"{name}_ms": statistics.median(v) for name, v in splits.items()}


def phase_s2d_train_path(rng, seed: int) -> dict:
    """The s2d training forward (``ops/s2d_train.py``) at full width: the
    float64 check against the parity step, the eval forward against the
    parity forward, ``S2D_TRAIN_STEPS`` float32 steps through
    ``make_train_step`` and a precise-BN pass through
    ``BNRefresher(S2DTrainForward)``, the trained weights served through
    ``VolumeSegmenter``'s s2d default (B2, both tie modes; no other kernel
    launched in the phase), the s2d and parity steps timed in turns, and
    ``S2D_BF16_STEPS`` bfloat16 s2d steps and as many bfloat16 parity
    steps, timed."""
    from oct_image_segmentation_models_torch.common.data_generator import DataGenerator
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.ops.s2d_train import (
        S2DTrainForward,
        maybe_build_s2d_train,
    )
    from oct_image_segmentation_models_torch.parallel.train_step import load_batch_stats
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_counts()
    out = {}

    # float64: one s2d step against one parity step on the card.
    images, labels = layered_dataset(rng, CHECK_BATCH, CHECK_H, CHECK_W, NUM_CLASSES)
    x64 = torch.from_numpy(images.astype(np.float64) / 255.0).cuda()
    y64 = torch.from_numpy(labels).cuda()
    base64 = check_size_unet(seed + 7).double()
    runs = {}
    for name in ("parity", "s2d"):
        module = copy.deepcopy(base64)
        forward = S2DTrainForward(module) if name == "s2d" else module
        runs[name] = step64(forward, module, x64, y64, seed)
    out["float64_check"] = compare64(runs["s2d"], runs["parity"])
    del base64, runs
    print(
        f"s2d train path: float64 s2d step vs parity step (batch {CHECK_BATCH} x "
        f"{CHECK_H}x{CHECK_W}, start_neurons 32, on the card): loss rel "
        f"{out['float64_check']['loss_rel']:.2e} (tolerance {S2D_LOSS_RTOL:g}), gradients "
        f"worst {out['float64_check']['grad_worst']:.2e} of the tensor's max "
        f"({out['float64_check']['grad_worst_tensor']}; tolerance {S2D_GRAD_TOL:g}), BN "
        f"statistics max |d| {out['float64_check']['stat_max_abs']:.2e} (tolerance "
        f"{S2D_STAT_ATOL:g})"
    )
    check64(out["float64_check"], "s2d against parity")

    container, module = build_unet(seed + 8)
    config = container.get_config()
    forward = maybe_build_s2d_train(module, config, H, W)
    if forward is None or forward.s2d_levels != 2:
        raise AssertionError("the bench's U-Net is not s2d-eligible at full width")
    preprocess = container.get_preprocess_input_fn()
    vx = torch.from_numpy(layered_bscans(rng, 2, H, W, NUM_CLASSES).astype(np.float32) / 255.0)
    probs = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.float64):
            parity = module if dtype == torch.float32 else copy.deepcopy(module).to(dtype)
            for name, fn in (("parity", parity), ("s2d", S2DTrainForward(parity))):
                probs[name, dtype] = fn.eval()(vx.cuda().to(dtype)).double()
            del parity

    def gap(a, b):
        return float((probs[a] - probs[b]).abs().max())

    f32, f64 = torch.float32, torch.float64
    out["eval_max_abs_err"] = gap(("s2d", f32), ("parity", f32))
    out["eval64_max_abs_err"] = gap(("s2d", f64), ("parity", f64))
    out["eval_off_float64"] = {n: gap((n, f32), (n, f64)) for n in ("s2d", "parity")}
    del probs
    print(
        f"s2d train path: eval-mode s2d forward vs parity forward (2 x {H}x{W}): float32 max "
        f"|d| {out['eval_max_abs_err']:.2e} (tolerance {PROB_ATOL:g}), float64 "
        f"{out['eval64_max_abs_err']:.2e} (tolerance {S2D_EVAL64_ATOL:g}); each float32 "
        f"forward off its float64 forward: s2d {out['eval_off_float64']['s2d']:.2e}, parity "
        f"{out['eval_off_float64']['parity']:.2e}"
    )
    if not (out["eval_max_abs_err"] <= PROB_ATOL and out["eval64_max_abs_err"] <= S2D_EVAL64_ATOL):
        raise AssertionError(
            f"s2d eval forward off the parity forward: {out['eval_max_abs_err']}, "
            f"float64 {out['eval64_max_abs_err']}"
        )

    # float32 training through make_train_step.
    train_x, train_y = layered_dataset(rng, TRAIN_IMAGES, H, W, NUM_CLASSES)
    test_x, test_y = layered_dataset(rng, BATCH, H, W, NUM_CLASSES)
    gen = DataGenerator(train_x, train_y, BATCH, [], "none", (), False, preprocess, seed=seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().cuda(non_blocking=True)

    fixed = []
    while len(fixed) < TURN_STEPS:
        fixed += [(upload(bx), upload(by)) for bx, by in gen]
        gen.on_epoch_end()
    fixed = fixed[:TURN_STEPS]
    state, step, _ = _train_objects(forward, seed)
    losses = []
    t0 = time.perf_counter()
    for i in range(S2D_TRAIN_STEPS):
        x, y = fixed[i % TURN_STEPS]
        _, loss, _ = step(state, x, y, generator)
        losses.append(loss)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    losses = torch.stack(losses).cpu().numpy()
    out["losses_first_last"] = (float(losses[0]), float(losses[-1]))
    print(
        f"s2d train path: {S2D_TRAIN_STEPS} float32 s2d steps at batch {BATCH} x {H}x{W}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({out['train_s']:.1f} s)"
    )
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"s2d training loss did not fall: {losses[0]} -> {losses[-1]}")

    # The s2d step and the parity step, timed in turns from the same state.
    parity_module = copy.deepcopy(module)
    p_state, p_step, _ = _train_objects(parity_module, seed)
    ms, peak = time_in_turns({"s2d": (state, step), "parity": (p_state, p_step)}, fixed, generator)
    for name, (st, fn) in (("s2d", (state, step)), ("parity", (p_state, p_step))):
        out[f"{name}_step_ms"] = min(ms[name])
        out[f"{name}_step_ms_runs"] = ms[name]
        out[f"{name}_peak_mib"] = peak[name]
        out.update({f"{name}_{k}": v for k, v in step_split(fn, st, fixed[:3], generator).items()})
        flop = train_flop(fn, st, *fixed[0], generator)
        out[f"{name}_gflop_per_step"] = flop / 1e9
        out[f"{name}_tflops"] = flop / 1e9 / out[f"{name}_step_ms"]
    del parity_module, p_state, p_step
    for name in ("s2d", "parity"):
        print(
            f"s2d train path: {name} step {out[f'{name}_step_ms']:.3f} ms (runs "
            f"{', '.join(f'{v:.3f}' for v in ms[name])}; forward with loss "
            f"{out[f'{name}_forward_ms']:.3f}, backward {out[f'{name}_backward_ms']:.3f}, "
            f"optimizer {out[f'{name}_optimizer_ms']:.3f} ms), "
            f"{out[f'{name}_gflop_per_step']:.1f} GFLOP, {out[f'{name}_tflops']:.2f} TFLOP/s, "
            f"peak {out[f'{name}_peak_mib']:.1f} MiB"
        )

    # Precise BN through the s2d forward, then serving (B2).
    stat_batches = [
        upload(preprocess(train_x[i:i + BATCH].astype(np.float32)))
        for i in range(0, TRAIN_IMAGES, BATCH)
    ]
    precise = BNRefresher(forward)(
        None, stat_batches, generator=torch.Generator(device="cuda").manual_seed(seed)
    )
    bad = [k for k, v in precise.items() if not torch.isfinite(v).all()]
    bad += [k for k, v in precise.items() if k.endswith("running_var") and not (v > 0).all()]
    if bad:
        raise AssertionError(f"s2d precise BN statistics not finite or var <= 0: {bad[:4]}")
    load_batch_stats(module, precise)
    module.eval()
    truth = test_y[..., 0]
    for tie in ("fast", "exact"):
        segmenter = VolumeSegmenter(
            LoadedModel("unet", module, config), config, batch_size=BATCH,
            minpath_tie_parity=tie, device="cuda",
        )
        if segmenter.kind != "s2d":
            raise AssertionError(f"VolumeSegmenter chose {segmenter.kind} for the s2d-trained U-Net")
        lab, rows = segmenter.segment_volume(test_x)
        check_rows(tie, lab, rows)
        out[f"served_dice_{tie}"] = float(np.mean([
            2 * ((lab == c) & (truth == c)).sum() / ((lab == c).sum() + (truth == c).sum())
            for c in range(NUM_CLASSES)
        ]))
    torch.cuda.synchronize()
    counts = read_counts()
    out["launches"] = counts["minpath_dp_s2d"]
    print(
        f"s2d train path: trained weights (precise BN through the s2d forward) served on "
        f"{BATCH} held-out B-scans through VolumeSegmenter's s2d default, dice_coef_macro "
        f"{out['served_dice_fast']:.4f}; launches {counts}"
    )
    if counts["minpath_dp_s2d"] < 1 or counts["minpath_dp"] or counts["s2d_enc_pair"]:
        raise AssertionError(f"the s2d train path launched {counts}")
    del state, step, forward, module, fixed, stat_batches
    torch.cuda.empty_cache()

    # bfloat16 s2d steps, and the bfloat16 parity step timed beside them.
    held = [
        (upload(preprocess(train_x[i:i + BATCH].astype(np.float32))), upload(train_y[i:i + BATCH]))
        for i in range(0, TRAIN_IMAGES, BATCH)
    ]
    batches = [held[i % len(held)] for i in range(S2D_BF16_STEPS)]
    for name in ("s2d", "parity"):
        bf16 = get_model_class("unet")(**{**config, "dtype": "bfloat16"}).build_model(
            generator=torch.Generator().manual_seed(seed + 9), device="cuda"
        )
        b_state, b_step, _ = _train_objects(S2DTrainForward(bf16) if name == "s2d" else bf16, seed)
        b_losses = [b_step(b_state, x, y, generator)[1] for x, y in batches[:2]]
        out[f"bf16_{name}_step_ms"] = timed_steps(b_step, b_state, batches[2:], generator)
        out[f"bf16_{name}_gflop_per_step"] = train_flop(b_step, b_state, *batches[0], generator) / 1e9
        b_losses = torch.stack(b_losses).float().cpu().numpy()
        if not np.isfinite(b_losses).all():
            raise AssertionError(f"bfloat16 {name} losses not finite: {b_losses}")
        out[f"bf16_{name}_losses_first"] = b_losses.tolist()
        del bf16, b_state, b_step
    del batches, held
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(
        f"s2d train path: {S2D_BF16_STEPS} bfloat16 steps at batch {BATCH} x {H}x{W}, ms/step "
        f"over the last {S2D_BF16_STEPS - 2}: s2d {out['bf16_s2d_step_ms']:.3f} "
        f"({out['bf16_s2d_gflop_per_step']:.1f} GFLOP), parity {out['bf16_parity_step_ms']:.3f} "
        f"({out['bf16_parity_gflop_per_step']:.1f} GFLOP); the phase {out['phase_s']:.1f} s"
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
# float32 step's own error. The card's and the CPU's errors are two
# roundings of one sum in different orders, so their ratio spreads with
# the data: over seeds 0-9 (tools/torch_deeplab_gate_probe.py, H100 80GB
# HBM3 at 700 W) the factor each seed needs, its largest card / CPU ratio
# among the tensors whose card error passes STEP_GRAD_RTOL, was 1.01-2.38
# (median 1.68), so 2.0 failed 2 of the 10. 4.0 sits at 3.1 standard
# deviations of the log of that spread above its mean.
DL_GRAD_CPU_FACTOR = 4.0


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


def deeplab_step_errors(rng, seed: int) -> dict:
    """One DeepLab train step at batch 2 of 64x128 on the card and on the
    CPU in float32 from the same weights and batch; the gradients of each
    against the CPU float64 step that replays that step's ReLU gates and
    max-pool picks. Returns the losses, the statistics' error, the
    pre-BN conv biases' share and, per tensor, ``(card's error, CPU's
    error, card's and CPU's error against the plain float64 step,
    name)``, each relative to the tensor's max."""
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
    gmax = max(float(g.abs().max()) for g in g64.values())

    def rel(got, want):
        return float((got - want).abs().max()) / float(want.abs().max())

    zero_grad, tensors = 0.0, []
    for k, g in g64.items():
        if k.endswith("conv.bias"):  # every conv bias but the head's feeds a BatchNorm
            zero_grad = max(zero_grad, float(g_cpu[k].abs().max()), float(g_card[k].abs().max()))
            continue
        tensors.append((rel(g_card[k], g64_card[k]), rel(g_cpu[k], g64_cpu[k]),
                        rel(g_card[k], g), rel(g_cpu[k], g), k))
    # the stem's running statistics reach ~1e2 (preprocessed inputs of
    # +-130): held relative to 1 + |value|
    stat_err = max(
        float(((s_card[k] - s_cpu[k]).abs() / (1 + s_cpu[k].abs())).max()) for k in s_cpu
    )
    return {
        "losses": (l_card, l_cpu), "metrics": (m_card, m_cpu), "tensors": tensors,
        "zero_grad_share": zero_grad / gmax, "stat_err": stat_err,
        "gate_flips_card": gate_flips(rec["card"], rec["cpu64"]),
        "gate_flips_cpu": gate_flips(rec["cpu"], rec["cpu64"]),
    }


def deeplab_step_card_vs_cpu(rng, seed: int) -> dict:
    """:func:`deeplab_step_errors`, gated: each tensor of the card's step
    within the larger of ``STEP_GRAD_RTOL`` and ``DL_GRAD_CPU_FACTOR``
    times the CPU float32 step's own error, against the float64 steps
    that replay each step's gates."""
    res = deeplab_step_errors(rng, seed)
    (l_card, l_cpu), (m_card, m_cpu) = res["losses"], res["metrics"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    rows = []
    for card_rel, cpu_rel, plain_card, plain_cpu, k in res["tensors"]:
        allowed = max(STEP_GRAD_RTOL, DL_GRAD_CPU_FACTOR * cpu_rel)
        rows.append((card_rel / allowed, card_rel, cpu_rel, plain_card, plain_cpu, k))
    rows.sort(reverse=True)
    worst = rows[0][0]
    card_max, cpu_max = max(r[1] for r in rows), max(r[2] for r in rows)
    plain_card, plain_cpu = max(r[3] for r in rows), max(r[4] for r in rows)
    flips_card, flips_cpu = res["gate_flips_card"], res["gate_flips_cpu"]
    zero_share, stat_err = res["zero_grad_share"], res["stat_err"]
    print(
        f"deeplab train step card vs CPU (batch {DL_CHECK_BATCH} x {DL_CHECK_H}x{DL_CHECK_W}, "
        f"float32): loss {l_card:.6f} / {l_cpu:.6f} (rel {loss_err:.2e}, tolerance "
        f"{STEP_LOSS_RTOL:g}), metric {m_card:.6f} / {m_cpu:.6f}, BN statistics max |diff| / "
        f"(1 + |value|) {stat_err:.2e} (tolerance {STEP_STAT_ATOL:g}), pre-BN conv bias "
        f"gradients {zero_share:.2e} of max |g| (bound {ZERO_GRAD_SHARE:g})"
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
    if worst > 1 or zero_share > ZERO_GRAD_SHARE:
        raise AssertionError(
            f"deeplab gradients off float64 with the same gates: {worst} of the allowance "
            f"({rows[0][-1]}); zero share {zero_share}"
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
        "zero_grad_share": zero_share,
        "bn_stat_rel_err": stat_err,
    }


def deeplab_train(seed: int) -> dict:
    """The DeepLab train step at batch 8 of 512x1024 from the port's
    DataGenerator (focal + Dice, Adam 1e-3, float32) timed with the
    default algorithms on a copy of the weights; then ``DL_TRAIN_STEPS``
    steps from the same weights, an eval step and one BNRefresher pass
    under deterministic algorithms, so that ``seed`` gives one set of
    trained weights on this card and software (``resize_bilinear``'s
    backward through ``DeterministicResize``); the trained weights served
    through B1. Draws from its own stream, ``default_rng([seed, 13])``."""
    from oct_image_segmentation_models_torch.common.data_generator import DataGenerator
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.parallel.train_step import load_batch_stats

    rng = np.random.default_rng([seed, 13])
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
    out = {}
    fixed = [next(stream) for _ in range(DL_TRAIN_WARMUP + DL_TRAIN_TIMED)]
    timed = copy.deepcopy(module)
    state, step, _ = _train_objects(timed, seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    for bx, by in fixed[:DL_TRAIN_WARMUP]:
        step(state, bx, by, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases = ("forward", "backward", "optimizer")
    splits = {name: [] for name in ("step",) + phases}
    for bx, by in fixed[DL_TRAIN_WARMUP:]:
        ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + phases}
        ev["start"].record()
        step(state, bx, by, generator, on_phase=lambda n: ev[n].record())
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
    del timed, state, step
    torch.cuda.empty_cache()

    state, step, evaluate = _train_objects(module, seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    losses = []
    with deterministic_algorithms() as caught:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DL_TRAIN_STEPS):
            bx, by = fixed[i] if i < len(fixed) else next(stream)
            losses.append(step(state, bx, by, generator)[1])
        torch.cuda.synchronize()
        out["loop_s"] = time.perf_counter() - t0
        vx, vy = fixed[0]
        val_loss, val_metric = evaluate(state, vx, vy)
        stat_batches = [
            upload(preprocess(train_x[i:i + BATCH])) for i in range(0, len(train_x), BATCH)
        ]
        precise = BNRefresher(module)(
            None, stat_batches, generator=torch.Generator(device="cuda").manual_seed(seed)
        )
    out["nondeterministic_ops"] = nondeterministic_ops(caught)
    if out["nondeterministic_ops"]:
        raise AssertionError(f"deeplab training ran {out['nondeterministic_ops']}")
    out["loop_bscans_per_s"] = BATCH * DL_TRAIN_STEPS / out["loop_s"]
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[0]), float(losses[-1])
    out["losses_first_last"], out["steps"] = (first, last), int(state.step)
    out["eval_ms"] = time_cuda(lambda: evaluate(state, vx, vy), iters=2, reps=3)
    out["val_loss"], out["val_metric"] = float(val_loss), float(val_metric)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    BNRefresher(module)(None, stat_batches)
    torch.cuda.synchronize()
    out["bn_refresh_ms"] = (time.perf_counter() - t0) * 1e3
    print(
        f"deeplab train: {out['steps']} steps at batch {BATCH} x {H}x{W} under deterministic "
        f"algorithms (ops without a deterministic kernel: none), loss {first:.4f} -> "
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
    out["_trained"] = (container, module)  # for the bfloat16 path, not printed
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
    out["train"] = deeplab_train(seed)
    out["_trained"] = out["train"].pop("_trained")
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


# --- the bfloat16 path ---------------------------------------------------

# Dense bfloat16 on the H100's tensor cores (SXM data sheet).
BF16_FLOPS_PER_S = 989e12
BF16_FWD_H, BF16_FWD_W, BF16_FWD_BATCH = 128, 256, 2
# The bfloat16 forward on the card against the CPU's, same weights: both
# round every conv's output to bfloat16, from float32 sums taken in
# another order, so a value near a rounding boundary lands one bfloat16
# ulp (2**-8 relative) apart and carries to the head. Kept apart from the
# float32 PROB_ATOL.
BF16_PROB_ATOL = 5e-2
# The reference's bfloat16 budget (JAX tests/test_s2d_unet.py, BASELINE):
# bfloat16 labels against float32 labels of trained weights, and the
# served rows' mean absolute difference in pixels.
BUDGET_AGREEMENT, BUDGET_MAE_PX = 0.995, 0.05
BF16_TRAIN_IMAGES = 32  # four batches of 8
BF16_TRAIN_STEPS = 32  # eight passes over the four batches
BF16_TRAIN_WARMUP, BF16_TRAIN_TIMED = 2, 5
# One bfloat16 train step, card against CPU: each rounds to bfloat16
# where its float32 sums fall, the batch statistics move values across
# rounding boundaries, and the flips carry through the backward (the
# CPU tests measure JAX's own bfloat16 gradients 0.05-0.6 in relative L2
# off the float64 step's at a small width). So per tensor the card's
# gradient is held within relative L2 BF16_GRAD_REL_L2 of the CPU's, the
# head's within BF16_HEAD_GRAD_REL_L2, the loss within BF16_LOSS_RTOL;
# and, against the CPU float64 step, the card's mean relative L2 error
# within BF16_ACCURACY_RATIO times the CPU bfloat16 step's.
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_REL_L2 = 0.6
BF16_HEAD_GRAD_REL_L2 = 0.05
BF16_ACCURACY_RATIO = 1.5


def bf16_forward_card_vs_cpu(rng, seed: int, trained_unet, trained_deeplab) -> dict:
    """The bfloat16 s2d U-Net and folded DeepLabV3+ forwards on the card
    against the CPU at 2 x 128x256, the same weights on both: the seeded
    weights of the bench's U-Net and of the DeepLabV3+ (as the float32
    checks take them), held to probabilities within ``BF16_PROB_ATOL`` and
    argmax agreement >= ``MIN_AGREEMENT``; then the trained weights of the
    train and DeepLabV3+ paths, whose numbers are printed and kept, not
    held: those models were trained at 512x1024, and at 128x256 many
    pixels sit near a tie."""
    from oct_image_segmentation_models_torch._device import precision
    from oct_image_segmentation_models_torch.models.deeplabv3plus import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.s2d_unet import build_s2d_apply

    images = layered_bscans(rng, BF16_FWD_BATCH, BF16_FWD_H, BF16_FWD_W, NUM_CLASSES)
    x_unet = torch.from_numpy(images.astype(np.float32) / 255.0)
    seeded_unet = build_unet(seed)[1]
    dl_container, seeded_deeplab = build_deeplab(seed, BF16_FWD_H, BF16_FWD_W)
    x_dl = torch.from_numpy(dl_container.get_preprocess_input_fn()(rgb(images)))

    def unet_pair(module):
        return (
            build_s2d_apply(module, output="probs", dtype="bfloat16"),
            build_s2d_apply(copy.deepcopy(module).cpu(), output="probs", dtype="bfloat16"),
            x_unet,
        )

    def deeplab_pair(module):
        return (
            fold_batchnorm(module, "bfloat16"),
            fold_batchnorm(copy.deepcopy(module).cpu(), "bfloat16"),
            x_dl,
        )

    cases = {
        "unet_s2d": (True, unet_pair(seeded_unet)),
        "deeplab_folded": (True, deeplab_pair(seeded_deeplab)),
        "unet_s2d_trained": (False, unet_pair(trained_unet)),
        "deeplab_folded_trained": (False, deeplab_pair(trained_deeplab)),
    }
    out = {}
    for name, (held, (card, cpu, x)) in cases.items():
        with torch.inference_mode(), precision(torch.bfloat16):
            p_card = card(x.cuda()).cpu()
            p_cpu = cpu(x)
        err = float((p_card - p_cpu).abs().max())
        agree = float((p_card.argmax(-1) == p_cpu.argmax(-1)).float().mean())
        print(
            f"bf16 {name} forward card vs CPU ({BF16_FWD_BATCH} x {BF16_FWD_H}x{BF16_FWD_W}): "
            f"max |dp| {err:.3e}, argmax agreement {agree:.6f}"
            + (f" (held: {BF16_PROB_ATOL:g}, >= {MIN_AGREEMENT})" if held else " (not held)")
        )
        if p_card.dtype != torch.float32 or not torch.isfinite(p_card).all():
            raise AssertionError(f"bf16 {name}: probabilities {p_card.dtype}, not finite float32")
        if held and (err > BF16_PROB_ATOL or agree < MIN_AGREEMENT):
            raise AssertionError(f"bf16 {name} card forward off the CPU's: {err}, {agree}")
        out[f"{name}_prob_max_abs_err"], out[f"{name}_argmax_agreement"] = err, agree
    return out


def bf16_serving(name, model_name, container, module, volume, kind, kernel) -> dict:
    """``VolumeSegmenter(compute_dtype="bfloat16")`` on ``volume`` in both
    tie modes: ``kernel`` alone launches, the rows pass ``check_rows``.
    Then the float32 segmenter on the same weights (fast ties) for the
    budget, its launches not counted: labels agreement and rows MAE."""
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    config = container.get_config()
    loaded = LoadedModel(model_name, module, config)
    segs = {
        tie: VolumeSegmenter(
            loaded, config, batch_size=BATCH, compute_dtype="bfloat16",
            minpath_tie_parity=tie, device="cuda",
        )
        for tie in ("fast", "exact")
    }
    if any(seg.kind != kind for seg in segs.values()):
        raise AssertionError(f"bf16 {name}: VolumeSegmenter chose {segs['fast'].kind}")
    reset_counts()
    served = {tie: seg.segment_volume(volume) for tie, seg in segs.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    variants = read_variants()
    others = {k: v for k, v in counts.items() if k != kernel and v}
    print(
        f"bf16 {name}: {len(volume)} B-scans through VolumeSegmenter(compute_dtype="
        f"'bfloat16', kind {kind}) in both tie modes, launches {counts}, variants {variants}"
    )
    if counts[kernel] < 1 or others:
        raise AssertionError(f"bf16 {name} launched {counts}, not {kernel} alone")
    for tie, (labels, rows) in served.items():
        check_rows(tie, labels, rows)
    f32 = VolumeSegmenter(loaded, config, batch_size=BATCH, device="cuda")
    lab32, rows32 = f32.segment_volume(volume)
    lab16, rows16 = served["fast"]
    agree = float((lab16 == lab32).mean())
    mae = float(np.abs(rows16.astype(np.float64) - rows32.astype(np.float64)).mean())
    print(
        f"bf16 {name} budget, trained weights, bfloat16 vs float32 serving on "
        f"{len(volume)} B-scans: label agreement {agree:.6f} (> {BUDGET_AGREEMENT}), rows "
        f"MAE {mae:.4f} px (< {BUDGET_MAE_PX})"
    )
    if not (agree > BUDGET_AGREEMENT and mae < BUDGET_MAE_PX):
        raise AssertionError(f"bf16 {name} outside the budget: agreement {agree}, MAE {mae}")
    return {
        "launches": counts[kernel],
        "variants": variants,
        "budget_agreement": agree,
        "budget_rows_mae_px": mae,
        "pipeline": segs["fast"]._pipeline,
    }


def bf16_serving_times(serving: dict, forward, x, batch) -> dict:
    """ms and B-scans/s of one batch through the bfloat16 pipeline, the
    forward's ms, GFLOP and TFLOP/s against dense bfloat16, and the
    pipeline's busy share."""
    from oct_image_segmentation_models_torch._device import precision

    out = {"pipeline_ms": time_cuda(lambda: serving["pipeline"](batch), iters=3)}
    out["pipeline_bscans_per_s"] = BATCH / out["pipeline_ms"] * 1e3
    with torch.inference_mode(), precision(torch.bfloat16):
        out["forward_gflop"] = forward_flop(forward, x) / 1e9
        out["forward_ms"] = time_cuda(lambda: forward(x), iters=3)
    out["forward_tflops"] = out["forward_gflop"] / out["forward_ms"]
    out["forward_share_of_bf16_peak"] = out["forward_tflops"] * 1e12 / BF16_FLOPS_PER_S
    out["forward_bound_ms"] = out["forward_gflop"] * 1e9 / BF16_FLOPS_PER_S * 1e3
    profiled = profile_pipeline(serving["pipeline"], batch)
    out["device_busy_share"] = profiled["device_busy_share"]
    out["device_ms_per_batch"] = profiled["device_ms_per_batch"]
    out["top_kernels_ms_per_batch"] = profiled["top_kernels_ms_per_batch"][:4]
    return out


def bf16_step_card_vs_cpu(rng, seed: int) -> dict:
    """One bfloat16 train step of the full-width U-Net at batch 2 of
    128x256 on the card and on the CPU, from the same weights, batch and
    dropout mask, and the CPU float64 step of the same weights, through
    the forward that ``train_forward_impl="auto"`` resolves to (the s2d
    training forward) and through the parity module."""
    card = unet_container(CHECK_H, CHECK_W, dtype="bfloat16").build_model(
        generator=torch.Generator().manual_seed(seed + 5), device="cuda"
    )
    _, kind = auto_forward(card, CHECK_H, CHECK_W)
    print(f"bf16 step check: train_forward_impl='auto' resolved to {kind} at {CHECK_H}x{CHECK_W}")
    if kind != "s2d":
        raise AssertionError(f"'auto' resolved to {kind} for the bfloat16 U-Net")
    initial = card.cpu()
    if not all(p.dtype == torch.float32 for p in initial.parameters()):
        raise AssertionError("the bfloat16 module's parameters are not float32")
    reference = check_size_unet(0, device="cpu")
    reference.load_state_dict(initial.state_dict())
    images, labels = layered_dataset(rng, CHECK_BATCH, CHECK_H, CHECK_W, NUM_CLASSES)
    x = torch.from_numpy(images.astype(np.float32) / 255.0)
    y = torch.from_numpy(labels)
    return {
        "auto_kind": kind,
        **{k: bf16_step_gate(k, initial, reference, x, y, seed) for k in (kind, "parity")},
    }


def bf16_step_gate(kind: str, initial, reference, x, y, seed: int) -> dict:
    """:func:`bf16_step_card_vs_cpu` for one forward, ``kind`` "s2d" or
    "parity"; ``reference`` is the float32 module of ``initial``'s
    weights."""
    from oct_image_segmentation_models_torch.models import unet as unet_module
    from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward

    masks = {}

    def shared_mask(t, generator):
        if "mask" not in masks:
            draw = torch.rand(t.shape, generator=torch.Generator().manual_seed(seed))
            masks["mask"] = draw < 1.0 - unet_module.DROPOUT_RATE
        return masks["mask"].to(t.device)

    def run(module):
        dev = next(module.parameters()).device
        forward = S2DTrainForward(module) if kind == "s2d" else module
        state, step, _ = _train_objects(forward, seed)
        _, loss, _ = step(state, x.to(dev), y.to(dev), None)
        return float(loss), {k: p.grad.detach().cpu().double() for k, p in module.named_parameters()}

    drawn = unet_module.dropout_mask
    unet_module.dropout_mask = shared_mask
    try:
        l_card, g_card = run(copy.deepcopy(initial).cuda())
        l_cpu, g_cpu = run(copy.deepcopy(initial))
        _, g64 = run(copy.deepcopy(reference).double())
    finally:
        unet_module.dropout_mask = drawn

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    worst, worst_head, err_card, err_cpu = ("", 0.0), 0.0, [], []
    for k, g in g64.items():
        if k.startswith("blocks.") and k.endswith("conv.bias"):
            continue  # exact gradient 0 (BatchNorm takes the mean out)
        if not torch.isfinite(g_card[k]).all():
            raise AssertionError(f"bf16 {kind} card gradient {k} not finite")
        r = rel(g_card[k], g_cpu[k])
        if k.startswith("head."):
            worst_head = max(worst_head, r)
        elif r > worst[1]:
            worst = (k, r)
        err_card.append(rel(g_card[k], g))
        err_cpu.append(rel(g_cpu[k], g))
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    mean_card, mean_cpu = float(np.mean(err_card)), float(np.mean(err_cpu))
    print(
        f"bf16 train step card vs CPU ({kind} forward, start_neurons 32, batch {CHECK_BATCH} x "
        f"{CHECK_H}x{CHECK_W}): loss {l_card:.6f} / {l_cpu:.6f} (rel {loss_err:.2e}, tolerance "
        f"{BF16_LOSS_RTOL:g}); gradients card vs CPU relative L2: worst {worst[1]:.3f} "
        f"({worst[0]}, tolerance {BF16_GRAD_REL_L2:g}), head {worst_head:.2e} (tolerance "
        f"{BF16_HEAD_GRAD_REL_L2:g}); mean relative L2 off the CPU float64 step: card "
        f"{mean_card:.4f}, CPU bfloat16 {mean_cpu:.4f} (ratio <= {BF16_ACCURACY_RATIO:g})"
    )
    if not (np.isfinite(l_card) and loss_err <= BF16_LOSS_RTOL):
        raise AssertionError(f"bf16 {kind} card train-step loss {l_card} off the CPU's {l_cpu}")
    if worst[1] > BF16_GRAD_REL_L2 or worst_head > BF16_HEAD_GRAD_REL_L2:
        raise AssertionError(f"bf16 {kind} card gradients off the CPU's: {worst}, head {worst_head}")
    if mean_card > BF16_ACCURACY_RATIO * mean_cpu:
        raise AssertionError(f"bf16 {kind} card gradients less accurate: {mean_card} vs {mean_cpu}")
    return {
        "loss_rel_err": loss_err,
        "grad_worst_rel_l2": worst[1],
        "grad_worst_tensor": worst[0],
        "grad_head_rel_l2": worst_head,
        "grad_mean_rel_l2_vs_float64_card": mean_card,
        "grad_mean_rel_l2_vs_float64_cpu": mean_cpu,
    }


def bf16_train(rng, seed: int) -> dict:
    """The bench's U-Net with ``dtype="bfloat16"`` trained
    ``BF16_TRAIN_STEPS`` steps at batch 8 of 512x1024 (focal + Dice, Adam
    1e-3) through the forward that ``train_forward_impl="auto"`` resolves
    to (the s2d training forward): ms per step, split, FLOPs and peak
    memory, and the parity step timed beside it in turns; the loss must
    fall."""
    container = unet_container(dtype="bfloat16")
    module = container.build_model(generator=torch.Generator().manual_seed(seed + 7), device="cuda")
    if module.compute_dtype != torch.bfloat16:
        raise AssertionError("the bfloat16 container built another module")
    forward, kind = auto_forward(module)
    print(f"bf16 train: train_forward_impl='auto' resolved to {kind} at {H}x{W}")
    if kind != "s2d":
        raise AssertionError(f"'auto' resolved to {kind} for the bfloat16 U-Net")
    preprocess = container.get_preprocess_input_fn()
    images, labels = layered_dataset(rng, BF16_TRAIN_IMAGES, H, W, NUM_CLASSES)
    batches = [
        (
            torch.from_numpy(preprocess(images[i:i + BATCH].astype(np.float32))).cuda(),
            torch.from_numpy(labels[i:i + BATCH]).cuda(),
        )
        for i in range(0, BF16_TRAIN_IMAGES, BATCH)
    ]
    state, step, _ = _train_objects(forward, seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    losses = []
    for i in range(BF16_TRAIN_WARMUP):
        losses.append(step(state, *batches[i % len(batches)], generator)[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases = ("forward", "backward", "optimizer")
    splits = {name: [] for name in ("step",) + phases}
    for i in range(BF16_TRAIN_WARMUP, BF16_TRAIN_WARMUP + BF16_TRAIN_TIMED):
        ev = {name: torch.cuda.Event(enable_timing=True) for name in ("start",) + phases}
        ev["start"].record()
        bx, by = batches[i % len(batches)]
        losses.append(step(state, bx, by, generator, on_phase=lambda n: ev[n].record())[1])
        ev["optimizer"].synchronize()
        for a, b in zip(("start",) + phases, phases):
            splits[b].append(ev[a].elapsed_time(ev[b]))
        splits["step"].append(ev["start"].elapsed_time(ev["optimizer"]))
    out = {f"{name}_ms": statistics.median(v) for name, v in splits.items()}
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["bscans_per_s"] = BATCH / out["step_ms"] * 1e3
    flop = train_flop(step, state, *batches[0], generator)
    # The parity step beside it, timed in turns from the same weights.
    parity_module = copy.deepcopy(module)
    p_state, p_step, _ = _train_objects(parity_module, seed)
    ms, _ = time_in_turns({kind: (state, step), "parity": (p_state, p_step)}, batches, generator)
    del parity_module, p_state, p_step
    out["auto_kind"] = kind
    out["turns_step_ms"] = {name: min(v) for name, v in ms.items()}
    out["turns_step_ms_runs"] = ms
    print(
        f"bf16 train: the {kind} step {out['turns_step_ms'][kind]:.3f} ms against the parity "
        f"step's {out['turns_step_ms']['parity']:.3f} ms, timed in turns"
    )
    for i in range(state.step, BF16_TRAIN_STEPS):
        losses.append(step(state, *batches[i % len(batches)], generator)[1])
    losses = torch.stack(losses).cpu().numpy()
    n = len(batches)
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    out.update(
        gflop_per_step=flop / 1e9,
        tflops=flop / 1e9 / out["step_ms"],
        share_of_bf16_peak=flop / out["step_ms"] * 1e3 / BF16_FLOPS_PER_S,
        bound_ms=flop / BF16_FLOPS_PER_S * 1e3,
        steps=int(state.step),
        loss_first_pass=first,
        loss_last_pass=last,
    )
    print(
        f"bf16 train: {out['steps']} steps at batch {BATCH} x {H}x{W}, mean loss over the "
        f"first pass of {n} batches {first:.4f} -> last pass {last:.4f}"
    )
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"bf16 training loss did not fall: {first} -> {last}")
    return out


def bf16_export(container, module, volume: np.ndarray) -> dict:
    """The trained U-Net as a directory checkpoint, exported in-process
    with ``compute_dtype="bfloat16"`` (s2d, a symbolic batch, fast ties)
    for the card, loaded and served on the 20-B-scan volume in batches of
    8, 8, 4: three B2 launches, bit-equal to eager bfloat16 serving."""
    import tempfile

    from oct_image_segmentation_models_torch.common.export import export_inference_pipeline
    from oct_image_segmentation_models_torch.common.model_io import (
        load_model_and_config,
        save_model_dir,
    )
    from oct_image_segmentation_models_torch.ops.inference import (
        make_fused_pipeline,
        select_optimized_forward,
    )

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_model_dir(tmp / "unet.orbax", "unet", container.get_config(), module.state_dict())
        t0 = time.perf_counter()
        artifact = export_inference_pipeline(
            tmp / "unet.orbax", tmp / "unet_bf16.pt2", image_height=H, image_width=W,
            batch_size=None, compute_dtype="bfloat16", platforms=("cuda",),
        )
        export_s = time.perf_counter() - t0
        loaded, config = load_model_and_config(tmp / "unet.orbax")
        forward, kind = select_optimized_forward(loaded.module, compute_dtype="bfloat16")
        eager = make_fused_pipeline(
            None, container.get_preprocess_input_fn(), labels_apply_fn=forward,
            num_classes=NUM_CLASSES, minpath_tie_parity="fast", device="cuda",
        )
        out = serve_artifact(
            "unet_s2d_bf16", artifact, eager, volume, "fast", "minpath_dp_s2d", export_s
        )
    if kind != "s2d" or out["optimized_forward"] != "s2d" or out["launches"] != 3:
        raise AssertionError(f"bf16 artifact: {kind}, {out['optimized_forward']}, {out['launches']}")
    return out


def phase_bf16_path(rng, seed: int, volume: np.ndarray, unet, deeplab) -> dict:
    """bfloat16 serving and training at full width: the forwards card vs
    CPU; ``VolumeSegmenter(compute_dtype="bfloat16")`` through B2 (s2d
    U-Net) and B1 (folded DeepLabV3+) in both tie modes on the trained
    weights of the train and DeepLabV3+ paths, each within the reference's
    bfloat16 budget of its float32 serving; one bfloat16 train step card
    vs CPU and ``BF16_TRAIN_STEPS`` at batch 8 of 512x1024; the bfloat16
    export artifact."""
    from oct_image_segmentation_models_torch.models.deeplabv3plus import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.s2d_unet import build_s2d_apply

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (unet_container, unet_module), (dl_container, dl_module) = unet, deeplab
    out = {"forward_check": bf16_forward_card_vs_cpu(rng, seed, unet_module, dl_module)}
    batch = torch.from_numpy(volume[:BATCH]).pin_memory()
    served = bf16_serving(
        "unet", "unet", unet_container, unet_module, volume, "s2d", "minpath_dp_s2d"
    )
    forward = build_s2d_apply(unet_module, output="labels_s2d", dtype="bfloat16")
    x = batch.cuda().to(torch.float32) / 255.0
    out["unet"] = {**served, **bf16_serving_times(served, forward, x, batch)}
    volume3 = rgb(volume)
    batch3 = torch.from_numpy(volume3[:BATCH]).pin_memory()
    served = bf16_serving(
        "deeplab", "deeplabv3plus", dl_container, dl_module, volume3, "folded", "minpath_dp"
    )
    forward = fold_batchnorm(dl_module, "bfloat16")
    x = dl_container.get_preprocess_input_fn()(batch3.cuda())
    out["deeplab"] = {**served, **bf16_serving_times(served, forward, x, batch3)}
    for name in ("unet", "deeplab"):
        del out[name]["pipeline"]
    del forward, x
    torch.cuda.empty_cache()
    out["step_check"] = bf16_step_card_vs_cpu(rng, seed)
    out["train"] = bf16_train(rng, seed)
    torch.cuda.empty_cache()
    out["export"] = bf16_export(unet_container, unet_module, volume)
    out["phase_s"] = time.perf_counter() - t0
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
# impl="spmd" over the two ranks against the one-device step on the global
# batch: in float64 the S2D_* bounds; in float32 the loss and each running
# statistic's tensor within this share of the one-device step's (sums over
# the world in another order). The metric thresholds the probabilities at
# 0.5, so a pixel on the threshold moves it: printed, not gated.
DP_SPMD_RTOL = 1e-5


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
    """The ops that warned, under :func:`deterministic_algorithms`, that
    they have no deterministic kernel (cuBLAS without a fixed workspace
    among them)."""
    ops = set()
    for w in caught:
        text = str(w.message)
        if "does not have a deterministic" in text:
            ops.add(text.split(" does not have a deterministic")[0])
        elif "CUBLAS_WORKSPACE_CONFIG" in text:
            ops.add("cuBLAS")
    return sorted(ops)


def kind_forward(module, kind: str, h: int = H, w: int = W):
    """The forward that trains ``module`` as ``kind``: the module itself
    for "parity", else the forward ``"auto"`` resolves to at ``h`` x
    ``w``, which must be of that kind."""
    if kind == "parity":
        return module
    forward, got = auto_forward(module, h, w)
    if got != kind:
        raise AssertionError(f"'auto' resolved to {got}, not {kind}")
    return forward


def world1_runs(base, batches, mesh, seed: int, kind: str) -> dict:
    """``DP_STEPS`` steps through DDP over ``mesh`` and through the
    one-device step, each over ``kind``'s forward, from ``base``'s weights
    with the same batches and dropout generator -> {name: (module, state,
    step, generator, losses)}."""
    runs = {}
    for name, kwargs in (("ddp", {"mesh": mesh, "impl": "shard_map"}), ("one", {})):
        module = copy.deepcopy(base)
        state, step, _ = _train_objects(kind_forward(module, kind), seed, **kwargs)
        gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        losses = [step(state, x, y, gen)[1] for x, y in batches]
        runs[name] = (module, state, step, gen, torch.stack(losses).cpu().numpy())
    return runs


def world1_kind(base, batches, mesh, seed: int, kind: str) -> dict:
    """:func:`dp_world_of_one` for ``kind``'s forward."""
    out = {}
    with deterministic_algorithms() as caught:
        runs = world1_runs(base, batches, mesh, seed, kind)
    out["nondeterministic_ops"] = nondeterministic_ops(caught)
    want = runs["one"][0].state_dict()
    got = runs["ddp"][0].state_dict()
    for part, keys in (
        ("param", [k for k in want if "running" not in k]),
        ("stat", [k for k in want if "running" in k]),
    ):
        out[part] = max(float((got[k] - want[k]).abs().max()) for k in keys)
    out["loss_max_abs_err"] = float(np.max(np.abs(runs["ddp"][4] - runs["one"][4])))
    if out["param"] or out["stat"] or out["loss_max_abs_err"]:
        raise AssertionError(f"DDP at world 1 over {kind} is not the one-device step: {out}")
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
    print(
        f"dp world of one (NCCL, DDP over the {kind} forward, batch {BATCH} x {H}x{W}, "
        f"{DP_STEPS} Adam steps under deterministic algorithms) vs the one-device step, bit for "
        f"bit: params max |d| {out['param']:.2e}, running stats {out['stat']:.2e}, losses "
        f"{out['loss_max_abs_err']:.2e} (tolerance 0); ops without a deterministic kernel: "
        f"{out['nondeterministic_ops'] or 'none'}; step {out['ddp_world1_step_ms']:.3f} ms with "
        f"DDP, {out['one_device_step_ms']:.3f} ms without"
    )
    return out


def dp_world_of_one(rng, model, seed: int) -> dict:
    """``impl="shard_map"`` (DDP) over a world of one on NCCL, at full
    width, against the one-device step from the same weights, batches and
    dropout generator, under deterministic algorithms, over the forward
    ``"auto"`` resolves to and over the parity module; then each pair
    timed in turns with the default algorithms -> {"auto_kind": kind,
    kind: results, "parity": results}."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from oct_image_segmentation_models_torch.parallel import mesh as mesh_lib

    container, base = model
    out = {"auto_kind": auto_forward(base)[1]}
    print(f"dp world of one: train_forward_impl='auto' resolved to {out['auto_kind']} at {H}x{W}")
    if out["auto_kind"] != "s2d":
        raise AssertionError(f"'auto' resolved to {out['auto_kind']} for the bench's U-Net")
    images, labels = layered_dataset(rng, BATCH * DP_STEPS, H, W, NUM_CLASSES)
    batches = [
        (
            torch.from_numpy(images[i:i + BATCH].astype(np.float32) / 255.0).cuda(),
            torch.from_numpy(labels[i:i + BATCH]).cuda(),
        )
        for i in range(0, BATCH * DP_STEPS, BATCH)
    ]
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_distributed(
            "cuda", rank=0, world_size=1, init_method=f"file://{tmp}/store",
            timeout=timedelta(seconds=DP_COLLECTIVE_TIMEOUT),
        )
        try:
            mesh = mesh_lib.create_mesh(device="cuda:0")
            if dist.get_backend() != "nccl" or mesh.world != 1:
                raise AssertionError(f"world of one on {dist.get_backend()}, {mesh.world}")
            for kind in (out["auto_kind"], "parity"):
                out[kind] = world1_kind(base, batches, mesh, seed, kind)
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return out


def _dp_rank_seed(seed: int, rank: int) -> int:
    return seed * 100 + rank


def dp_rank_training(rank: int, mesh, module, inputs: dict, seed: int, kind: str) -> dict:
    """:func:`dp_rank`'s training checks over ``kind``'s forward: the
    DDP step, the spmd steps (float64 at the check size, float32 at full
    width, timed) and the cross-rank refresher."""
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher

    out = {}
    # One step from common weights, each rank on its rows (DDP over the
    # forward).
    rows = mesh.local_rows(BATCH)
    train_module = copy.deepcopy(module)
    forward = kind_forward(train_module, kind)
    state, step, _ = _train_objects(forward, seed, mesh=mesh, impl="shard_map")
    gen = torch.Generator(device="cuda").manual_seed(_dp_rank_seed(seed, rank))
    x, y = inputs["x"][rows].cuda(), inputs["y"][rows].cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss, metric = step(state, x, y, gen)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["loss"], out["metric"] = float(loss), float(metric)
    out["grads"] = {k: p.grad.cpu() for k, p in train_module.named_parameters()}
    out["stats"] = {k: v.cpu() for k, v in train_module.state_dict().items() if "running" in k}
    del train_module, forward, state, step

    # impl="spmd": the one-device step on the global batch (every rank's
    # randoms from one stream), in float64 at the check size, then in
    # float32 at full width, then timed.
    rows64 = mesh.world_rows(inputs["x64"].shape[0])
    m64 = check_size_unet(seed + 10).double()
    out["spmd64"] = step64(
        kind_forward(m64, kind, CHECK_H, CHECK_W), m64, inputs["x64"][rows64].cuda(),
        inputs["y64"][rows64].cuda(), seed + 11, mesh, "spmd",
    )
    del m64
    spmd_module = copy.deepcopy(module)
    state, step, _ = _train_objects(kind_forward(spmd_module, kind), seed, mesh=mesh, impl="spmd")
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    rows = mesh.world_rows(BATCH)
    x, y = inputs["x"][rows].cuda(), inputs["y"][rows].cuda()
    _, loss, metric = step(state, x, y, gen)
    out["spmd32"] = (
        float(loss), float(metric), {k: v.cpu() for k, v in spmd_module.state_dict().items()},
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED):
        step(state, x, y, gen)
    torch.cuda.synchronize()
    out["spmd_step_ms"] = (time.perf_counter() - t0) / DP_TIMED * 1e3
    del spmd_module, state, step

    # The cross-rank precise-BN refresher on this rank's batches.
    refresher = BNRefresher(kind_forward(module, kind), deterministic=True)
    batches = [b.cuda() for b in inputs["stat_x"][rank]]
    out["refreshed"] = {
        k: v.cpu() for k, v in refresher(None, batches, cross_process=True).items()
    }
    torch.cuda.empty_cache()
    return out


def dp_rank(rank: int, workdir: str, seed: int) -> None:
    """One of ``DP_RANKS`` ranks that share ``cuda:0`` over gloo (NCCL
    refuses two ranks on one device). Runs in a process of its own, started
    with the ``spawn`` method; writes its results to ``workdir``."""
    from datetime import timedelta

    import torch.distributed as dist

    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
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
        # Training through the forward "auto" resolves to, then through
        # the parity module.
        out["auto_kind"] = auto_forward(module)[1]
        out["train"] = {
            kind: dp_rank_training(rank, mesh, module, inputs, seed, kind)
            for kind in (out["auto_kind"], "parity")
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


def dp_training_checks(ranks: list, base, inputs: dict, stat_x, seed: int, kind: str) -> dict:
    """The ranks' training results over ``kind``'s forward
    (:func:`dp_rank_training`, one per rank) against their one-process
    definitions on the card."""
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher

    out = {}
    # The per-replica definition: the one-device step on each rank's rows
    # with its generator, then the means.
    local = []
    for r in range(DP_RANKS):
        module = copy.deepcopy(base)
        state, step, _ = _train_objects(kind_forward(module, kind), seed)
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
        f"dp two ranks on one card ({kind} forward, gloo, local batch {DP_LOCAL_BATCH} x "
        f"{H}x{W}), one step against the per-replica definition: loss {got['loss']:.6f} / {want_loss:.6f} (rel "
        f"{loss_err:.2e}), metric rel {metric_err:.2e} (tolerance {DP_LOSS_RTOL:g}), gradients "
        f"worst tensor {grad_err:.3f} of {STEP_GRAD_RTOL:g} * max |g| + {STEP_GRAD_ATOL:g}, "
        f"pre-BN conv biases {zero_grad / gmax:.2e} of max |g| (bound {ZERO_GRAD_SHARE:g}), "
        f"running stats max |d| {stat_err:.2e} (tolerance {DP_STAT_ATOL:g})"
    )
    if loss_err > DP_LOSS_RTOL or metric_err > DP_LOSS_RTOL:
        raise AssertionError(f"two-rank loss/metric off the per-replica mean: {loss_err}, {metric_err}")
    if grad_err > 1 or zero_grad > ZERO_GRAD_SHARE * gmax or stat_err > DP_STAT_ATOL:
        raise AssertionError(
            f"two-rank {kind} step off the per-replica definition: {grad_err}, {stat_err}"
        )

    # impl="spmd" against the one-device step on the global batch, from
    # the same weights and dropout stream; every rank's state bit-equal.
    for name, index in (("spmd64", 3), ("spmd32", 2)):
        a, b = ranks[0][name][index], ranks[1][name][index]
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        if diff:
            raise AssertionError(f"{name}: the ranks' states differ in {diff[:4]}")
    m64 = check_size_unet(seed + 10).double()
    want64 = step64(
        kind_forward(m64, kind, CHECK_H, CHECK_W), m64, inputs["x64"].cuda(),
        inputs["y64"].cuda(), seed + 11,
    )
    del m64
    out["spmd64"] = compare64(ranks[0]["spmd64"], want64)
    module = copy.deepcopy(base)
    state, step, _ = _train_objects(kind_forward(module, kind), seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    _, loss, metric = step(state, inputs["x"].cuda(), inputs["y"].cuda(), gen)
    got_loss, got_metric, got_sd = ranks[0]["spmd32"]
    spmd_loss = abs(got_loss - float(loss)) / abs(float(loss))
    spmd_metric = abs(got_metric - float(metric)) / max(abs(float(metric)), 1e-12)
    spmd_stat = max(
        float((got_sd[k] - v.cpu()).abs().max()) / max(float(v.abs().max()), 1e-12)
        for k, v in module.state_dict().items() if "running" in k
    )
    del module, state, step
    out.update(
        spmd32_loss_rel=spmd_loss, spmd32_metric_rel=spmd_metric,
        spmd32_stat_rel=spmd_stat, spmd_step_ms=[r["spmd_step_ms"] for r in ranks],
    )
    print(
        f"dp spmd over {DP_RANKS} gloo ranks on one card ({kind} forward): float64 step "
        f"(global batch {DP_RANKS * CHECK_BATCH} x {CHECK_H}x{CHECK_W}) vs the one-device step: loss rel "
        f"{out['spmd64']['loss_rel']:.2e}, gradients worst {out['spmd64']['grad_worst']:.2e} "
        f"of the tensor's max ({out['spmd64']['grad_worst_tensor']}), statistics max |d| "
        f"{out['spmd64']['stat_max_abs']:.2e}; float32 step (global batch {BATCH} x {H}x{W}): "
        f"loss rel {spmd_loss:.2e}, statistics {spmd_stat:.2e} of the tensor's max "
        f"(tolerance {DP_SPMD_RTOL:g}), the thresholded metric rel {spmd_metric:.2e} (not "
        f"gated: a pixel at 0.5 flips it); ranks' states "
        f"bit-equal; {out['spmd_step_ms'][0]:.3f} ms per spmd step on rank 0 (two ranks "
        f"share one card over gloo: no scaling number)"
    )
    check64(out["spmd64"], f"{kind} spmd against the one-device step")
    if not (spmd_loss <= DP_SPMD_RTOL and spmd_stat <= DP_SPMD_RTOL):
        raise AssertionError(
            f"float32 {kind} spmd step off the one-device step: {spmd_loss}, {spmd_stat}"
        )

    # The cross-rank refresher against the one-process one over all batches.
    batches = [b.cuda() for b in stat_x.reshape(-1, DP_LOCAL_BATCH, H, W, 1)]
    want_stats = BNRefresher(kind_forward(base, kind), deterministic=True)(None, batches)
    refresh_err = 0.0
    for k, w in want_stats.items():
        g = got["refreshed"][k]
        excess = (g - w.cpu()).abs() - (DP_REFRESH_ATOL + DP_REFRESH_RTOL * w.cpu().abs())
        refresh_err = max(refresh_err, float((g - w.cpu()).abs().max()))
        if float(excess.max()) > 0:
            raise AssertionError(f"{kind} cross-rank refresher off the one-process one at {k}")
    out["refresh_max_abs_err"] = refresh_err
    print(
        f"dp cross-rank BNRefresher ({kind} forward, {DP_RANKS} x {DP_STAT_BATCHES} batches of "
        f"{DP_LOCAL_BATCH}) vs the one-process refresher over all of them: max |d| "
        f"{refresh_err:.2e} (tolerance {DP_REFRESH_ATOL:g} + {DP_REFRESH_RTOL:g} * |v|)"
    )
    return out


def dp_two_ranks(rng, model, volume: np.ndarray, seed: int) -> dict:
    """``DP_RANKS`` ranks on the card over gloo, spawned, against the
    per-replica definition computed here on the card."""
    import multiprocessing
    import tempfile

    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    container, base = model
    images, labels = layered_dataset(rng, BATCH, H, W, NUM_CLASSES)
    stat_x = layered_bscans(rng, DP_RANKS * DP_STAT_BATCHES * DP_LOCAL_BATCH, H, W, NUM_CLASSES)
    stat_x = torch.from_numpy(stat_x.astype(np.float32) / 255.0).reshape(
        DP_RANKS, DP_STAT_BATCHES, DP_LOCAL_BATCH, H, W, 1
    )
    images64, labels64 = layered_dataset(rng, DP_RANKS * CHECK_BATCH, CHECK_H, CHECK_W, NUM_CLASSES)
    inputs = {
        "weights": {k: v.cpu() for k, v in base.state_dict().items()},
        "x": torch.from_numpy(images.astype(np.float32) / 255.0),
        "y": torch.from_numpy(labels),
        "x64": torch.from_numpy(images64.astype(np.float64) / 255.0),
        "y64": torch.from_numpy(labels64),
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

    kinds = [r["auto_kind"] for r in ranks]
    print(f"dp two ranks: train_forward_impl='auto' resolved to {kinds} at {H}x{W}")
    if kinds != ["s2d"] * DP_RANKS:
        raise AssertionError(f"'auto' resolved to {kinds} on the ranks")
    out["auto_kind"] = kinds[0]
    for kind in (kinds[0], "parity"):
        out[kind] = dp_training_checks(
            [r["train"][kind] for r in ranks], base, inputs, stat_x, seed, kind
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


# The workflow path: the file-backed entry points as a user calls them.
WF_SPLITS = (("train", 48), ("val", 16), ("test", 16))  # B-scans per split
WF_EPOCHS = 2
WF_LR = 1e-3


@contextlib.contextmanager
def recording(owner, name: str, record: list):
    """Wrap ``owner.name`` so that each call's arguments and result are
    appended to ``record``; restored on exit."""
    original = getattr(owner, name)

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        record.append((args, kwargs, out))
        return out

    setattr(owner, name, wrapped)
    try:
        yield record
    finally:
        setattr(owner, name, original)


def write_workflow_dataset(path: Path, seed: int) -> tuple:
    """A reference-schema dataset (the keys of ``tests/synth.py::
    make_dataset``: ``{split}_images``, ``{split}_labels`` as ``(n, H, W,
    1)`` uint8, ``test_images_source``) written with the port's HDF5
    layer, then read back through it bit for bit -> (arrays, write s,
    read s, bytes)."""
    from oct_image_segmentation_models_torch.common import h5

    rng = np.random.default_rng([seed, 12])
    arrays = {}
    for split, n in WF_SPLITS:
        arrays[f"{split}_images"], arrays[f"{split}_labels"] = layered_dataset(
            rng, n, H, W, NUM_CLASSES
        )
    n_test = dict(WF_SPLITS)["test"]
    arrays["test_images_source"] = np.array(
        [f"bscan_{i:03d}.png".encode("ascii") for i in range(n_test)]
    )
    attrs = {"image_height": H, "image_width": W, "num_channels": 1,
             "type": np.array("fullsize", dtype="S100")}
    t0 = time.perf_counter()
    with h5.File(path, "w") as f:
        for key, value in arrays.items():
            f.create_dataset(key, data=value)
        for key, value in attrs.items():
            f.attrs[key] = value
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with h5.File(path, "r") as f:
        back = {key: f[key][()] for key in f}
        back_attrs = {key: f.attrs[key] for key in f.attrs}
    read_s = time.perf_counter() - t0
    for key, value in arrays.items():
        if back[key].dtype != value.dtype or not np.array_equal(back[key], value):
            raise AssertionError(f"dataset {key} read back differs")
    if sorted(back) != sorted(arrays) or back_attrs != attrs:
        raise AssertionError(f"dataset keys {sorted(back)} / attributes {back_attrs}")
    nbytes = sum(v.nbytes for v in arrays.values())
    return arrays, write_s, read_s, nbytes


def read_hdf5_tree(path: Path) -> dict:
    """Every dataset and attribute of an HDF5 file, read through the
    port's layer: ``{name: value}``, attributes as ``name@attr``."""
    from oct_image_segmentation_models_torch.common import h5

    out = {}
    with h5.File(path, "r") as f:
        out.update({f"@{k}": v for k, v in f.attrs.items()})

        def visit(name, obj):
            out.update({f"{name}@{k}": v for k, v in obj.attrs.items()})
            if isinstance(obj, h5.Dataset):
                out[name] = obj[()]

        f.visititems(visit)
    return out


def phase_workflow_path(seed: int, train_step_ms: float) -> dict:
    """``train_model``, ``predict`` and ``evaluate_model`` through their
    normal entry points and files, on the bench's U-Net at full width,
    every HDF5 file through the port's layer (no h5py)."""
    import importlib.util
    import tempfile

    from oct_image_segmentation_models_torch.common import EVALUATION_METRICS, model_io
    from oct_image_segmentation_models_torch.common.dataset import Dataset
    from oct_image_segmentation_models_torch.common.utils import load_model_and_config
    from oct_image_segmentation_models_torch.evaluation import (
        EvaluationParameters,
        EvaluationSaveParams,
        evaluate_model,
    )
    from oct_image_segmentation_models_torch.prediction import (
        PredictionParams,
        PredictionSaveParams,
        predict,
    )
    from oct_image_segmentation_models_torch.prediction.prediction import run_pipeline
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter
    from oct_image_segmentation_models_torch.training import (
        TrainingParams,
        train_model,
        training,
    )

    t_phase = time.perf_counter()
    present = {m: importlib.util.find_spec(m) is not None for m in ("h5py", "matplotlib")}
    print(f"workflow path: installed {present}")
    out = {"installed": present}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ds_path = tmp / "dataset.hdf5"
        arrays, write_s, read_s, nbytes = write_workflow_dataset(ds_path, seed)
        out.update(dataset_bytes=nbytes, dataset_write_s=write_s, dataset_read_s=read_s,
                   dataset_read_gb_per_s=nbytes / read_s / 1e9,
                   dataset_write_gb_per_s=nbytes / write_s / 1e9)
        print(
            f"workflow dataset ({', '.join(f'{s} {n}' for s, n in WF_SPLITS)} B-scans at "
            f"{H}x{W}, {nbytes / 1e6:.1f} MB): written in {write_s:.3f} s, read back bit "
            f"for bit in {read_s:.3f} s = {out['dataset_read_gb_per_s']:.2f} GB/s"
        )
        test_images = arrays["test_images"]
        n_test = len(test_images)

        reset_counts()
        forwards, saves = [], []
        t0 = time.perf_counter()
        with recording(training, "resolve_train_forward", forwards), \
                recording(model_io, "save_model", saves):
            folder = train_model(TrainingParams(
                model_architecture="unet", training_dataset_path=ds_path,
                initial_model=None, results_location=tmp / "train", opt_con="adam",
                opt_params={"learning_rate": WF_LR}, loss="focal_dice_loss",
                metric="dice_coef_macro", epochs=WF_EPOCHS, batch_size=BATCH,
                model_hyperparameters={"start_neurons": 32, "pool_layers": 4,
                                       "conv_layers": 2},
                seed=seed,
            ))
        train_s = time.perf_counter() - t0
        kinds = sorted({res[1] for _, _, res in forwards})
        if kinds != ["s2d"]:
            raise AssertionError(f"train_model trained through {kinds}, not the s2d forward")
        final_path = folder / "model_final.hdf5"
        final = [args[3] for args, _, _ in saves if Path(args[0]) == final_path]
        if len(final) != 1:
            raise AssertionError(f"model_final.hdf5 written {len(final)} times")
        final_state = {k: v.detach().cpu().clone() for k, v in final[0].items()}
        files = sorted(p for p in folder.rglob("*") if p.is_file())
        print(f"train_model ({train_s:.2f} s, forward {kinds[0]}) wrote {folder.name}/:")
        for p in files:
            print(f"  {p.relative_to(folder)}  {p.stat().st_size} bytes")
        trees = {p.name: read_hdf5_tree(p) for p in files if p.suffix == ".hdf5"}
        stats = trees.get(f"stats_epoch{WF_EPOCHS:02d}.hdf5")
        if stats is None:
            raise AssertionError(f"no stats_epoch{WF_EPOCHS:02d}.hdf5 in {sorted(trees)}")
        for key in ("train_acc", "val_acc", "train_loss", "val_loss", "epoch_time"):
            if stats[key].shape != (WF_EPOCHS,) or not np.isfinite(stats[key]).all():
                raise AssertionError(f"stats {key} = {stats[key]}")
        applied = trees["training_params.hdf5"].get("@bn_precise_stats_applied")
        if not (isinstance(applied, np.bool_) and applied):
            raise AssertionError(f"bn_precise_stats_applied = {applied!r}")
        epoch_s = [float(s) for s in stats["epoch_time"]]
        n_train = dict(WF_SPLITS)["train"]
        out.update(
            train_s=train_s, forward_kind=kinds[0], epoch_s=epoch_s,
            train_bscans_per_s=[n_train / s for s in epoch_s],
            train_loss=stats["train_loss"].tolist(), val_acc=stats["val_acc"].tolist(),
            artifacts=[str(p.relative_to(folder)) for p in files],
        )
        print(
            f"train_model epochs: {', '.join(f'{s:.3f}' for s in epoch_s)} s = "
            f"{', '.join(f'{n_train / s:.2f}' for s in epoch_s)} B-scans/s (train step "
            f"of train_path {train_step_ms:.3f} ms); train loss "
            f"{stats['train_loss'].tolist()}, val {stats['val_acc'].tolist()}"
        )

        t0 = time.perf_counter()
        loaded, config = load_model_and_config(final_path)
        out["checkpoint_load_ms"] = (time.perf_counter() - t0) * 1e3
        state = loaded.module.state_dict()
        for key, value in final_state.items():
            if not torch.equal(state[key].cpu(), value):
                raise AssertionError(f"model_final.hdf5 {key} differs from the trained module")
        t0 = time.perf_counter()
        model_io.save_model(tmp / "again.hdf5", "unet", config, final_state)
        out["checkpoint_write_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        model_io.read_checkpoint(tmp / "again.hdf5")
        out["checkpoint_read_ms"] = (time.perf_counter() - t0) * 1e3
        out["checkpoint_bytes"] = final_path.stat().st_size
        print(
            f"model_final.hdf5 ({out['checkpoint_bytes']} bytes) bit-equal to the trained "
            f"module; checkpoint write {out['checkpoint_write_ms']:.1f} ms, read "
            f"{out['checkpoint_read_ms']:.1f} ms, load_model_and_config "
            f"{out['checkpoint_load_ms']:.1f} ms"
        )

        segmenter = VolumeSegmenter(loaded, config, batch_size=BATCH)
        if segmenter.kind != "s2d":
            raise AssertionError(f"VolumeSegmenter chose {segmenter.kind}, not s2d")
        seg_labels, seg_rows = segmenter.segment_volume(test_images)
        names = [Path(s.decode()) for s in arrays["test_images_source"]]
        predicted, predict_s = {}, {}
        for tie in ("fast", "exact"):
            pdir = tmp / f"predict_{tie}"
            pdir.mkdir()
            t0 = time.perf_counter()
            predicted[tie] = predict(PredictionParams(
                model_path=final_path, mlflow_tracking_uri=None, mlflow_run_uuid=None,
                dataset=Dataset(test_images, None, names,
                                [pdir / f"image_{i}" for i in range(n_test)]),
                config_output_dir=pdir,
                save_params=PredictionSaveParams(png_images=False),
                graph_search=True, batch_size=BATCH, minpath_tie_parity=tie,
            ))
            predict_s[tie] = time.perf_counter() - t0
        eval_dir = tmp / "evaluate"
        t0 = time.perf_counter()
        evaluated = evaluate_model(EvaluationParameters(
            model_path=final_path, mlflow_tracking_uri=None, mlflow_run_uuid=None,
            test_dataset_path=ds_path, save_foldername=eval_dir,
            save_params=EvaluationSaveParams(png_images=False),
            graph_search=True, metrics=sorted(EVALUATION_METRICS), batch_size=BATCH,
            minpath_tie_parity="fast",
        ))
        evaluate_s = time.perf_counter() - t0
        counts, variants = read_counts(), read_variants()
        print(
            f"workflow path launches {counts}, variants {variants}; predict "
            f"{predict_s['fast']:.2f} s (fast) / {predict_s['exact']:.2f} s (exact), "
            f"evaluate_model {evaluate_s:.2f} s on {n_test} B-scans"
        )
        if counts["minpath_dp"] < 1 or counts["minpath_dp_s2d"] < 1:
            raise AssertionError(f"the workflow path did not launch B1 and B2: {counts}")
        if counts["s2d_enc_pair"]:
            raise AssertionError(f"the workflow path launched B3: {counts}")

        check_rows("fast", seg_labels, seg_rows)
        for tie, outs in predicted.items():
            reference = run_pipeline(loaded, config, list(test_images), BATCH, True,
                                     minpath_tie_parity=tie)
            labels, rows = [], []
            for i, res in enumerate(outs):
                info = read_hdf5_tree(res.image_output_dir / "prediction_info.hdf5")
                gs = read_hdf5_tree(
                    res.image_output_dir / "graph_search_prediction_info.hdf5"
                )
                for key, got, want in (
                    ("predicted_labels", info["predicted_labels"], reference["predicted_labels"][i]),
                    ("boundary_maps", info["boundary_maps"], reference["boundary_maps"][i]),
                    ("raw_image", info["raw_image"], test_images[i]),
                    ("gs_pred_segs", gs["gs_pred_segs"], reference["gs_pred_segs"][i]),
                    ("gs_predicted_labels", gs["gs_predicted_labels"], reference["gs_masks"][i]),
                ):
                    if got.shape != np.shape(want) or not np.array_equal(got, want):
                        raise AssertionError(f"predict {tie} image {i}: {key} differs from run_pipeline")
                if info["@image_name"] != str(names[i]).encode():
                    raise AssertionError(f"image_name {info['@image_name']!r}")
                labels.append(info["predicted_labels"])
                rows.append(gs["gs_pred_segs"])
            check_rows(tie, np.stack(labels), np.stack(rows))
        fast_rows = [r.gs_pred_segs for r in predicted["fast"]]
        for i, res in enumerate(evaluated):
            got = read_hdf5_tree(res.image_output_dir / "gs_evaluation_results.hdf5")
            if not np.array_equal(got["gs_pred_segs"], fast_rows[i]):
                raise AssertionError(f"evaluate_model image {i}: rows differ from predict's")
        overall = read_hdf5_tree(eval_dir / "overall_evaluation_results.hdf5")
        dice = overall["dice_coef_classes"]
        if dice.shape[0] != n_test or not np.isfinite(dice).all() or (
            (dice < 0) | (dice > 1)
        ).any():
            raise AssertionError(f"overall Dice {dice}")
        out.update(
            launches=counts, predict_s=predict_s, evaluate_s=evaluate_s,
            mean_dice_classes=overall["mean_dice_coef_classes"].tolist(),
            mean_gs_dice_classes=overall["mean_gs_dice_coef_classes"].tolist(),
            gs_mean_abs_errors_px=overall["mean_abs_errors"].tolist(),
            predict_files=sum(1 for _ in (tmp / "predict_fast").rglob("*")),
            evaluate_files=sum(1 for _ in eval_dir.rglob("*")),
        )
        print(
            f"predict (both tie modes) and evaluate_model files read back equal to "
            f"run_pipeline in memory, rows equal the plain min-path on their labels; "
            f"mean Dice per class {out['mean_dice_classes']}"
        )
    if sys.modules.get("h5py") is not None:
        raise AssertionError("h5py was imported during the workflow path")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"workflow path phase {out['phase_s']:.1f} s")
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
    # Its own random stream, so that the phases after it draw the inputs
    # they drew before it was added.
    s2d_train = phase_s2d_train_path(np.random.default_rng([args.seed, 10]), args.seed)
    # Its own random stream too (its step gate's allowance is set from a
    # spread measured over seeds; tools/torch_deeplab_gate_probe.py).
    deeplab = phase_deeplab_path(np.random.default_rng([args.seed, 11]), args.seed, volume)
    export = phase_export_path(model, args.seed, volume)
    bf16 = phase_bf16_path(rng, args.seed, volume, train.pop("_trained"), deeplab.pop("_trained"))
    dp = phase_dp_path(rng, model, volume, args.seed)
    workflow = phase_workflow_path(args.seed, train["step_ms"])

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
        f"[{card}] train step, the {train['auto_kind']} forward (train_forward_impl='auto'; "
        f"batch {BATCH} x {H}x{W}, start_neurons 32, float32, TF32 "
        f"off, Adam, focal+Dice): {train['step_ms']:.3f} ms/step = "
        f"{train['bscans_per_s']:.2f} B-scans/s; {train['gflop_per_step']:.1f} GFLOP/step, "
        f"{train['tflops']:.2f} TFLOP/s (float32 bound {train['bound_ms']:.3f} ms); split "
        f"forward with loss and metric {train['forward_ms']:.3f} ms, backward "
        f"{train['backward_ms']:.3f} ms, optimizer {train['optimizer_ms']:.3f} ms; peak "
        f"memory {train['peak_mib']:.1f} MiB"
    )
    tt = train["turns_step_ms"]
    print(
        f"[{card}] train step timed in turns with the parity step (batch {BATCH} x {H}x{W}, "
        f"float32): {train['auto_kind']} {tt[train['auto_kind']]:.3f} ms, parity "
        f"{tt['parity']:.3f} ms"
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
        f"{dtr['bn_refresh_ms']:.3f} ms; the {DL_TRAIN_STEPS}-step training loop under "
        f"deterministic algorithms {dtr['loop_bscans_per_s']:.2f} B-scans/s"
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
            + export_launches["minpath_dp"] + bf16["deeplab"]["launches"]
            + workflow["launches"]["minpath_dp"],
            parity["max_abs_err"],
            "b1",
            f"{tpu_minpath}:487",
        ),
        (
            "minpath_dp_s2d",
            s2d["launches"] + train["launches"]["minpath_dp_s2d"] + s2d_train["launches"]
            + sum(dp["two_ranks"]["b2_launches_per_rank"])
            + export_launches["minpath_dp_s2d"] + bf16["unet"]["launches"]
            + bf16["export"]["launches"] + workflow["launches"]["minpath_dp_s2d"],
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
            line["launches_bf16_path"] = bf16["deeplab"]["launches"]
            line["launches_workflow_path"] = workflow["launches"]["minpath_dp"]
        if key == "b2":
            line["launches_s2d_path"] = s2d["launches"]
            line["launches_train_path"] = train["launches"]["minpath_dp_s2d"]
            line["launches_s2d_train_path"] = s2d_train["launches"]
            line["launches_dp_path_per_rank"] = dp["two_ranks"]["b2_launches_per_rank"]
            line["launches_export_path"] = export_launches["minpath_dp_s2d"]
            line["launches_bf16_path"] = bf16["unet"]["launches"] + bf16["export"]["launches"]
            line["launches_workflow_path"] = workflow["launches"]["minpath_dp_s2d"]
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
            "s2d_train_path": s2d_train,
            "deeplab_path": deeplab,
            "export_path": export,
            "bf16_path": bf16,
            "dp_path": dp,
            "workflow_path": workflow,
            "kernels": kernels,
            "total_s": time.perf_counter() - t_start,
        }
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    w1, two = dp["world1"], dp["two_ranks"]
    dp_kinds = (w1["auto_kind"], "parity")
    for kind in dp_kinds:
        print(
            f"[{card}] dp path, the {kind} forward: world of one (NCCL) train step "
            f"{w1[kind]['ddp_world1_step_ms']:.3f} ms with DDP, "
            f"{w1[kind]['one_device_step_ms']:.3f} ms without; spmd step over two ranks on the "
            f"card (gloo) {two[kind]['spmd_step_ms'][0]:.3f} ms on rank 0"
        )
    print(
        f"[{card}] dp path: two ranks on the card (gloo) {two['ranks_wall_s']:.1f} s for both "
        f"ranks' work, spawn included; the phase {dp['phase_s']:.1f} s"
    )
    bu, bd, bt, bs = bf16["unet"], bf16["deeplab"], bf16["train"], bf16["step_check"]
    for name, res in (("U-Net s2d (B2)", bu), ("DeepLabV3+ folded (B1)", bd)):
        busy = res["device_busy_share"]
        print(
            f"[{card}] bf16 {name} VolumeSegmenter pipeline batch {BATCH} x {H}x{W}, fast "
            f"ties: {res['pipeline_ms']:.3f} ms/batch, {res['pipeline_bscans_per_s']:.1f} "
            f"B-scans/s; forward {res['forward_ms']:.3f} ms, {res['forward_gflop']:.1f} GFLOP, "
            f"{res['forward_tflops']:.2f} TFLOP/s = {res['forward_share_of_bf16_peak']:.4f} of "
            f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 (bound "
            f"{res['forward_bound_ms']:.3f} ms); busy share "
            + ("not measured" if busy is None else f"{busy:.4f}")
            + f"; budget agreement {res['budget_agreement']:.6f}, rows MAE "
            f"{res['budget_rows_mae_px']:.4f} px"
        )
        for kname, ms in res["top_kernels_ms_per_batch"]:
            print(f"  {ms:9.3f} ms/batch  {kname[:100]}")
    print(
        f"[{card}] bf16 train step, the {bt['auto_kind']} forward (train_forward_impl='auto'; "
        f"U-Net, batch {BATCH} x {H}x{W}, start_neurons 32, Adam, "
        f"focal+Dice): {bt['step_ms']:.3f} ms/step = {bt['bscans_per_s']:.2f} B-scans/s; "
        f"{bt['gflop_per_step']:.1f} GFLOP/step, {bt['tflops']:.2f} TFLOP/s = "
        f"{bt['share_of_bf16_peak']:.4f} of dense bf16 (bound {bt['bound_ms']:.3f} ms); split "
        f"forward with loss and metric {bt['forward_ms']:.3f} ms, backward "
        f"{bt['backward_ms']:.3f} ms, optimizer {bt['optimizer_ms']:.3f} ms; peak memory "
        f"{bt['peak_mib']:.1f} MiB; timed in turns: {bt['auto_kind']} "
        f"{bt['turns_step_ms'][bt['auto_kind']]:.3f} ms, parity "
        f"{bt['turns_step_ms']['parity']:.3f} ms; the bf16_path phase {bf16['phase_s']:.1f} s"
    )
    st = s2d_train
    print(
        f"[{card}] s2d train step (batch {BATCH} x {H}x{W}, start_neurons 32, float32, TF32 "
        f"off, Adam, focal+Dice): {st['s2d_step_ms']:.3f} ms/step against the parity step's "
        f"{st['parity_step_ms']:.3f} ms in the same run; {st['s2d_gflop_per_step']:.1f} against "
        f"{st['parity_gflop_per_step']:.1f} GFLOP/step; peak {st['s2d_peak_mib']:.1f} against "
        f"{st['parity_peak_mib']:.1f} MiB; bf16 s2d step {st['bf16_s2d_step_ms']:.3f} ms "
        f"against the bf16 parity step's {st['bf16_parity_step_ms']:.3f} ms; the phase "
        f"{st['phase_s']:.1f} s"
    )
    wf = workflow
    print(
        f"[{card}] workflow path (train_model {WF_EPOCHS} epochs at batch {BATCH} of "
        f"{dict(WF_SPLITS)['train']} B-scans at {H}x{W}, the {wf['forward_kind']} forward, "
        f"checkpoint_format hdf5): "
        + ", ".join(f"{s:.3f} s" for s in wf["epoch_s"]) + " per epoch = "
        + ", ".join(f"{b:.2f}" for b in wf["train_bscans_per_s"])
        + f" B-scans/s (train step {train['step_ms']:.3f} ms); dataset read "
        f"{wf['dataset_read_gb_per_s']:.2f} GB/s; checkpoint write "
        f"{wf['checkpoint_write_ms']:.1f} ms, read {wf['checkpoint_read_ms']:.1f} ms; predict "
        f"{wf['predict_s']['fast']:.2f} s (fast) / {wf['predict_s']['exact']:.2f} s (exact), "
        f"evaluate_model {wf['evaluate_s']:.2f} s on {dict(WF_SPLITS)['test']} B-scans; "
        f"the phase {wf['phase_s']:.1f} s"
    )
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"bf16": {
        "unet_s2d_pipeline_ms": bu["pipeline_ms"],
        "unet_s2d_bscans_per_s": bu["pipeline_bscans_per_s"],
        "unet_s2d_forward_tflops": bu["forward_tflops"],
        "unet_s2d_busy_share": bu["device_busy_share"],
        "unet_budget_agreement": bu["budget_agreement"],
        "unet_budget_rows_mae_px": bu["budget_rows_mae_px"],
        "deeplab_folded_pipeline_ms": bd["pipeline_ms"],
        "deeplab_folded_bscans_per_s": bd["pipeline_bscans_per_s"],
        "deeplab_folded_forward_tflops": bd["forward_tflops"],
        "deeplab_folded_busy_share": bd["device_busy_share"],
        "deeplab_budget_agreement": bd["budget_agreement"],
        "deeplab_budget_rows_mae_px": bd["budget_rows_mae_px"],
        "forward_card_vs_cpu": bf16["forward_check"],
        "b2_launches": bu["launches"],
        "b1_launches": bd["launches"],
        "train_step_ms": bt["step_ms"],
        "train_bscans_per_s": bt["bscans_per_s"],
        "train_tflops": bt["tflops"],
        "train_forward_backward_optimizer_ms": [
            bt["forward_ms"], bt["backward_ms"], bt["optimizer_ms"]
        ],
        "train_peak_mib": bt["peak_mib"],
        "train_loss_first_last_pass": [bt["loss_first_pass"], bt["loss_last_pass"]],
        "step_check": bs,
        "export_artifact_ms_per_batch": bf16["export"]["artifact_ms_per_batch"],
        "export_b2_launches": bf16["export"]["launches"],
        "phase_s": bf16["phase_s"],
    }}))
    print(json.dumps({"s2d_train": {
        k: st[k] for k in (
            "float64_check", "eval_max_abs_err", "eval64_max_abs_err", "eval_off_float64",
            "losses_first_last", "s2d_step_ms",
            "parity_step_ms", "s2d_step_ms_runs", "parity_step_ms_runs", "s2d_forward_ms",
            "s2d_backward_ms", "s2d_optimizer_ms", "parity_forward_ms", "parity_backward_ms",
            "parity_optimizer_ms", "s2d_gflop_per_step", "parity_gflop_per_step",
            "s2d_peak_mib", "parity_peak_mib", "bf16_s2d_step_ms", "bf16_parity_step_ms",
            "bf16_s2d_gflop_per_step", "bf16_parity_gflop_per_step", "served_dice_fast",
            "launches", "phase_s",
        )
    }}))
    sc = train["step_check"]
    print(json.dumps({"train_default": {
        "auto_kind": train["auto_kind"],
        "step_ms": train["step_ms"],
        "turns_step_ms": train["turns_step_ms"],
        "turns_step_ms_runs": train["turns_step_ms_runs"],
        "gflop_per_step": train["gflop_per_step"],
        "peak_mib": train["peak_mib"],
        "losses_first_last": train["losses_first_last"],
        "grad_gate": {k: sc[k] for k in (sc["auto_kind"], "parity")},
        "bf16_auto_kind": bt["auto_kind"],
        "bf16_step_ms": bt["step_ms"],
        "bf16_turns_step_ms": bt["turns_step_ms"],
        "dp_auto_kind": w1["auto_kind"],
        "deeplab_grad_worst_of_allowance": dck["grad_card_worst_of_allowance"],
    }}))
    print(json.dumps({"dp": {
        "auto_kind": w1["auto_kind"],
        **{kind: {
            "world1_ddp_step_ms": w1[kind]["ddp_world1_step_ms"],
            "world1_one_device_step_ms": w1[kind]["one_device_step_ms"],
            "world1_param_max_abs_err": w1[kind]["param"],
            "world1_stat_max_abs_err": w1[kind]["stat"],
            "world1_loss_max_abs_err": w1[kind]["loss_max_abs_err"],
            "two_rank_loss_rel_err": two[kind]["step_loss_rel_err"],
            "two_rank_metric_rel_err": two[kind]["step_metric_rel_err"],
            "two_rank_grad_worst_of_allowance": two[kind]["step_grad_worst_of_allowance"],
            "two_rank_stat_max_abs_err": two[kind]["step_stat_max_abs_err"],
            "two_rank_refresh_max_abs_err": two[kind]["refresh_max_abs_err"],
            "spmd64": two[kind]["spmd64"],
            "spmd32_loss_rel": two[kind]["spmd32_loss_rel"],
            "spmd32_metric_rel": two[kind]["spmd32_metric_rel"],
            "spmd32_stat_rel": two[kind]["spmd32_stat_rel"],
            "spmd_step_ms_per_rank": two[kind]["spmd_step_ms"],
        } for kind in dp_kinds},
        "two_rank_serving_bit_equal": True,
        "b1_launches_per_rank": two["b1_launches_per_rank"],
        "b2_launches_per_rank": two["b2_launches_per_rank"],
        "two_rank_wall_s": two["ranks_wall_s"],
        "phase_s": dp["phase_s"],
    }}))
    print(json.dumps({"workflow": {k: v for k, v in workflow.items() if k != "artifacts"}}))
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
