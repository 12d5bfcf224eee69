#!/usr/bin/env python3
"""How far two identical training runs of the PyTorch port drift apart on
the card, with and without deterministic algorithms.

    python3 tools/torch_bn_drift_probe.py [--seed 0] [--steps 120]

Repeats the training of ``chip_smoke.py``'s ``train_path``: the bench's
U-Net at full width (start_neurons=32, pool_layers=4, conv_layers=2, 4
classes) from seeded weights, ``DataGenerator`` batches of 8 from 32
synthetic 512x1024 B-scans, focal + Dice, Adam 1e-3, float32 with TF32 off,
``--steps`` steps, then the eval step on a held-out batch with the rolling
BatchNorm statistics. Two runs in each mode, from the same seed and data:

- "deterministic": ``chip_smoke.deterministic_algorithms()``
  (``torch.use_deterministic_algorithms(True, warn_only=True)`` and
  ``cudnn.deterministic``; ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA
  starts); the ops that have no deterministic kernel are listed from
  their warnings;
- "default": the settings ``train_model`` runs with.

For each mode it prints the largest difference between the two runs'
running statistics (absolute, and relative to the value), their
parameters, the first step whose losses differ, and both runs' eval loss
and dice; last, one JSON line with every number. It needs the card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, set before CUDA starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    BATCH,
    H,
    NUM_CLASSES,
    TRAIN_IMAGES,
    W,
    _train_objects,
    build_unet,
    card_line,
    deterministic_algorithms,
    layered_dataset,
    nondeterministic_ops,
)
from oct_image_segmentation_models_torch.common.data_generator import DataGenerator  # noqa: E402
from oct_image_segmentation_models_torch.parallel.train_step import batch_stats  # noqa: E402


def train_once(seed: int, steps: int) -> dict:
    rng = np.random.default_rng(seed)
    container, module = build_unet(seed)
    preprocess = container.get_preprocess_input_fn()
    train_x, train_y = layered_dataset(rng, TRAIN_IMAGES, H, W, NUM_CLASSES)
    val_x, val_y = layered_dataset(rng, BATCH, H, W, NUM_CLASSES)
    gen = DataGenerator(train_x, train_y, BATCH, [], "none", (), False, preprocess, seed=seed)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    state, step, evaluate = _train_objects(module, seed)
    losses = []
    while len(losses) < steps:
        for bx, by in gen:
            if len(losses) == steps:
                break
            x = torch.from_numpy(np.ascontiguousarray(bx)).cuda()
            y = torch.from_numpy(np.ascontiguousarray(by)).cuda()
            losses.append(step(state, x, y, generator)[1])
        gen.on_epoch_end()
    vx = torch.from_numpy(preprocess(val_x.astype(np.float32))).cuda()
    val_loss, val_dice = evaluate(state, vx, torch.from_numpy(val_y).cuda())
    return {
        "losses": torch.stack(losses).cpu().numpy(),
        "stats": {k: v.cpu().double() for k, v in batch_stats(module).items()},
        "params": {k: p.detach().cpu().double() for k, p in module.named_parameters()},
        "eval": (float(val_loss), float(val_dice)),
    }


def compare(a: dict, b: dict) -> dict:
    stat_abs, stat_rel = 0.0, 0.0
    for k, v in a["stats"].items():
        d = (v - b["stats"][k]).abs()
        stat_abs = max(stat_abs, float(d.max()))
        stat_rel = max(stat_rel, float((d / v.abs().clamp_min(1e-6)).max()))
    param_abs = max(float((v - b["params"][k]).abs().max()) for k, v in a["params"].items())
    differ = np.nonzero(a["losses"] != b["losses"])[0]
    return {
        "stat_max_abs_drift": stat_abs,
        "stat_max_rel_drift": stat_rel,
        "param_max_abs_drift": param_abs,
        "first_step_losses_differ": int(differ[0]) + 1 if differ.size else None,
        "losses_first_last": [float(a["losses"][0]), float(a["losses"][-1])],
        "eval_loss_dice": [list(a["eval"]), list(b["eval"])],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=120)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bn_drift_probe: no CUDA device; this probe needs the card", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = {"card": card, "steps": args.steps}
    for mode in ("deterministic", "default"):
        ctx = deterministic_algorithms() if mode == "deterministic" else contextlib.nullcontext([])
        with ctx as caught:
            runs = [train_once(args.seed, args.steps) for _ in range(2)]
        nondeterministic = nondeterministic_ops(caught)
        out = compare(*runs)
        out["ops_without_deterministic_kernel"] = nondeterministic
        result[mode] = out
        (l1, d1), (l2, d2) = out["eval_loss_dice"]
        print(
            f"[{card}] {mode}: {args.steps} steps twice; running statistics max |d| "
            f"{out['stat_max_abs_drift']:.3e} (relative {out['stat_max_rel_drift']:.3e}), "
            f"parameters max |d| {out['param_max_abs_drift']:.3e}, first step whose losses "
            f"differ {out['first_step_losses_differ']}; loss {out['losses_first_last'][0]:.4f} "
            f"-> {out['losses_first_last'][1]:.4f}; eval on the rolling statistics: loss "
            f"{l1:.4f} / {l2:.4f}, dice {d1:.4f} / {d2:.4f}"
        )
        if nondeterministic:
            print(f"  ops without a deterministic kernel: {nondeterministic}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
