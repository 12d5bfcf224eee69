#!/usr/bin/env python3
"""The space-to-depth training path and the spmd steps of ``chip_smoke.py``
alone, on the card.

    python3 tools/torch_s2d_spmd_probe.py [--seed 0]

Builds the kernels (``chip_smoke.phase_environment``), then runs
``chip_smoke.phase_s2d_train_path`` (the float64 s2d-against-parity step,
the eval forward, float32 training through the s2d forward, the s2d and
parity steps timed in turns, precise BN, serving through B2, bfloat16 s2d
and parity steps), ``chip_smoke.bf16_train`` (the bfloat16 path's train
step timing), :func:`bf16_timing_methods` (the bfloat16 and float32
parity and s2d steps, each timed back to back and one synchronised step
at a time) and ``chip_smoke.dp_two_ranks`` (two gloo ranks on the card: the
per-replica step, the spmd steps against the one-device step on the
global batch, the cross-rank refresher, serving over the mesh). A part
that fails prints its traceback and the other still runs; the exit code
is the number of parts that failed. Last it prints the card's name and
power limit. It needs the card and imports nothing of JAX; a quick check
of these phases before the whole ``chip_smoke.py`` (about 5 minutes of
command time).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def bf16_timing_methods(seed: int, steps: int = 12) -> dict:
    """The bfloat16 parity and s2d steps at batch 8 of 512x1024, each
    timed three ways on the same state: ``steps`` steps back to back
    between two CUDA events (as ``chip_smoke.timed_steps``), the same on
    the host clock, and one step at a time between events with a
    synchronise after each (as ``chip_smoke.bf16_train``)."""
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward

    rng = np.random.default_rng([seed, 11])
    images, labels = cs.layered_dataset(rng, 4 * cs.BATCH, cs.H, cs.W, cs.NUM_CLASSES)
    batches = [
        (torch.from_numpy(images[i:i + cs.BATCH].astype(np.float32) / 255.0).cuda(),
         torch.from_numpy(labels[i:i + cs.BATCH]).cuda())
        for i in range(0, 4 * cs.BATCH, cs.BATCH)
    ]
    generator = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for dtype in ("bfloat16", "float32"):
        for name in ("parity", "s2d"):
            module = get_model_class("unet")(
                input_channels=1, num_classes=cs.NUM_CLASSES, image_height=cs.H,
                image_width=cs.W, start_neurons=32, pool_layers=4, conv_layers=2, dtype=dtype,
            ).build_model(generator=torch.Generator().manual_seed(seed), device="cuda")
            state, step, _ = cs._train_objects(
                S2DTrainForward(module) if name == "s2d" else module, seed
            )
            for x, y in batches[:2]:
                step(state, x, y, generator)
            run = [batches[i % len(batches)] for i in range(steps)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events_ms = cs.timed_steps(step, state, run, generator)
            host_ms = (time.perf_counter() - t0) / steps * 1e3
            synced = []
            for x, y in run:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                step(state, x, y, generator)
                b.record()
                b.synchronize()
                synced.append(a.elapsed_time(b))
            out[f"{dtype}_{name}"] = {
                "back_to_back_events_ms": events_ms,
                "back_to_back_host_ms": host_ms,
                "synced_median_ms": float(np.median(synced)),
            }
            print(f"{dtype} {name} step: {out[f'{dtype}_{name}']}")
            del module, state, step
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_s2d_spmd_probe: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    env = cs.phase_environment()
    failed = 0
    results = {}
    for name, run in (
        ("s2d_train_path", lambda: cs.phase_s2d_train_path(rng, args.seed)),
        # The bf16_path's own bfloat16 parity step timing, in this process
        # after the s2d phase's (whose timing runs the steps back to back).
        ("bf16_train", lambda: cs.bf16_train(rng, args.seed)),
        ("timing_methods", lambda: bf16_timing_methods(args.seed)),
        ("dp_two_ranks", lambda: cs.dp_two_ranks(
            rng, cs.build_unet(args.seed),
            cs.layered_bscans(rng, cs.VOLUME, cs.H, cs.W, cs.NUM_CLASSES), args.seed,
        )),
    ):
        t0 = time.perf_counter()
        try:
            res = run()
            results[name] = {
                k: v for k, v in res.items()
                if isinstance(v, (int, float, str, list, tuple, dict)) and not k.startswith("_")
            }
            print(f"{name}: ok in {time.perf_counter() - t0:.1f} s")
        except Exception:
            failed += 1
            traceback.print_exc()
            print(f"{name}: FAILED after {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    print(json.dumps(results, default=str))
    print(env["card"])
    return failed


if __name__ == "__main__":
    sys.exit(main())
