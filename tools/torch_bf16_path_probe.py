#!/usr/bin/env python3
"""The bfloat16 path of ``chip_smoke.py`` alone, on the card.

    python3 tools/torch_bf16_path_probe.py [--seed 0]

Builds the kernels (``chip_smoke.phase_environment``), trains the bench's
U-Net (``chip_smoke.phase_train_path``) and DeepLabV3+
(``chip_smoke.deeplab_train``) as the whole script does, then runs each
part of ``chip_smoke.phase_bf16_path`` on its own: the bfloat16 forwards
card vs CPU, ``VolumeSegmenter(compute_dtype="bfloat16")`` through B2 and
B1 with the budget against float32 serving and the times, the bfloat16
train step card vs CPU, bfloat16 training at full width, and the bfloat16
export artifact. A part that fails prints its traceback and the others
still run; the exit code is the number of parts that failed. Last it
prints the card's name and power limit. It needs the card and imports
nothing of JAX; a quick check of the bfloat16 path before the whole
``chip_smoke.py`` (about 4 minutes of command time).
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bf16_path_probe: no CUDA device", file=sys.stderr)
        return 2
    from oct_image_segmentation_models_torch.models.deeplabv3plus import fold_batchnorm
    from oct_image_segmentation_models_torch.ops.s2d_unet import build_s2d_apply

    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(cs.phase_environment(), flush=True)
    rng = np.random.default_rng(args.seed)
    volume = cs.layered_bscans(rng, cs.VOLUME, cs.H, cs.W, cs.NUM_CLASSES)
    t0 = time.perf_counter()
    unet = cs.phase_train_path(rng, args.seed)["_trained"]
    deeplab = cs.deeplab_train(rng, args.seed)["_trained"]
    print(f"training both models {time.perf_counter() - t0:.1f} s", flush=True)
    failed = 0

    def part(name, fn):
        nonlocal failed
        t = time.perf_counter()
        try:
            result = fn()
        except Exception:  # noqa: BLE001 - every part runs and reports
            failed += 1
            traceback.print_exc()
            print(f"{name}: FAILED after {time.perf_counter() - t:.1f} s", flush=True)
            return None
        result = {k: v for k, v in result.items() if k != "pipeline"}
        print(f"{name} ({time.perf_counter() - t:.1f} s): {result}", flush=True)
        return result

    batch = torch.from_numpy(volume[:cs.BATCH]).pin_memory()
    part(
        "forward card vs CPU",
        lambda: cs.bf16_forward_card_vs_cpu(rng, args.seed, unet[1], deeplab[1]),
    )

    def serve_unet():
        served = cs.bf16_serving("unet", "unet", *unet, volume, "s2d", "minpath_dp_s2d")
        forward = build_s2d_apply(unet[1], output="labels_s2d", dtype="bfloat16")
        x = batch.cuda().to(torch.float32) / 255.0
        return {**served, **cs.bf16_serving_times(served, forward, x, batch)}

    def serve_deeplab():
        volume3 = cs.rgb(volume)
        batch3 = torch.from_numpy(volume3[:cs.BATCH]).pin_memory()
        served = cs.bf16_serving(
            "deeplab", "deeplabv3plus", *deeplab, volume3, "folded", "minpath_dp"
        )
        x = deeplab[0].get_preprocess_input_fn()(batch3.cuda())
        forward = fold_batchnorm(deeplab[1], "bfloat16")
        return {**served, **cs.bf16_serving_times(served, forward, x, batch3)}

    part("serving U-Net", serve_unet)
    part("serving DeepLabV3+", serve_deeplab)
    torch.cuda.empty_cache()
    part("train step card vs CPU", lambda: cs.bf16_step_card_vs_cpu(rng, args.seed))
    part("training", lambda: cs.bf16_train(rng, args.seed))
    torch.cuda.empty_cache()
    part("export", lambda: cs.bf16_export(*unet, volume))
    print(f"bf16 parts {failed} failed, {time.perf_counter() - t0:.1f} s with training")
    print(cs.card_line())
    return failed


if __name__ == "__main__":
    sys.exit(main())
