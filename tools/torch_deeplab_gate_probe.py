#!/usr/bin/env python3
"""The spread of the DeepLabV3+ train-step gate of ``chip_smoke.py`` over
seeds, on the card.

    python3 tools/torch_deeplab_gate_probe.py [--seeds 0 1 2 ...] [--out FILE]
        [--budget-seeds 0 1 ...] [--budget-repeats 1]

For each seed, ``chip_smoke.deeplab_step_errors`` with the weights of
``seed + 2`` and a batch from ``np.random.default_rng([seed, 12])``: one
DeepLabV3+ train step at batch 2 of 64x128 on the card and on the CPU in
float32, each step's gradients against the CPU float64 step that replays
its ReLU gates and max-pool picks, per tensor relative to its max. The
gate holds the card's error of each tensor to the larger of
``STEP_GRAD_RTOL`` and ``DL_GRAD_CPU_FACTOR`` times the CPU's. Per seed
it prints the tensors whose card error exceeds ``STEP_GRAD_RTOL`` (where
the factor binds) with their ratio card / CPU, and the factor that seed
needs (the largest such ratio); then the ratios over every seed, and the
worst tensor over its allowance at the script's ``DL_GRAD_CPU_FACTOR``.
With ``--budget-seeds``, for each of those seeds and ``--budget-repeats``
times, ``chip_smoke.deeplab_train(seed)`` trains the ``deeplab_path``
phase's DeepLabV3+ (under deterministic algorithms) and the trained
weights serve 20 B-scans of 512x1024 from ``np.random.default_rng(0)``
in bfloat16 and float32 (``VolumeSegmenter``): the bfloat16 path's
budget, label agreement and rows MAE, which the ``bf16_path`` phase
gates, and a digest of the trained weights, equal over a seed's repeats
when the training is reproducible. Last it prints the card's name and
power limit. It needs the card and imports nothing of JAX (about 10 s a
gate seed, 40 s a budget run).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def bf16_budget(seed: int, volume3) -> dict:
    """The ``deeplab_path`` phase's trained DeepLabV3+ for ``seed`` served
    in bfloat16 and float32: label agreement, rows MAE, and a digest of
    the trained weights."""
    import hashlib

    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    trained = cs.deeplab_train(seed)
    container, module = trained["_trained"]
    digest = hashlib.sha256()
    for k, v in module.state_dict().items():
        digest.update(k.encode() + v.detach().cpu().numpy().tobytes())
    config = container.get_config()
    loaded = LoadedModel("deeplabv3plus", module, config)
    out = {}
    for name, kw in (("bf16", {"compute_dtype": "bfloat16"}), ("f32", {})):
        seg = VolumeSegmenter(loaded, config, batch_size=cs.BATCH, device="cuda", **kw)
        out[name] = seg.segment_volume(volume3)
    (lab16, rows16), (lab32, rows32) = out["bf16"], out["f32"]
    return {
        "agreement": float((lab16 == lab32).mean()),
        "rows_mae_px": float(np.abs(rows16.astype(np.float64) - rows32.astype(np.float64)).mean()),
        "served_dice": trained["served_dice"],
        "loss_first_last": trained["losses_first_last"],
        "weights_sha256": digest.hexdigest()[:16],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="*", default=list(range(10)))
    parser.add_argument("--budget-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--budget-repeats", type=int, default=1)
    parser.add_argument("--out", help="also write every number to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_deeplab_gate_probe: no CUDA device", file=sys.stderr)
        return 2
    budgets = []
    if args.budget_seeds:
        print(cs.phase_environment(), flush=True)
        rng = np.random.default_rng(0)
        volume3 = cs.rgb(cs.layered_bscans(rng, cs.VOLUME, cs.H, cs.W, cs.NUM_CLASSES))
    for seed in args.budget_seeds:
        for rep in range(args.budget_repeats):
            res = bf16_budget(seed, volume3)
            budgets.append({"seed": seed, "repeat": rep, **res})
            print(
                f"bf16 budget, seed {seed} run {rep}: agreement {res['agreement']:.6f} "
                f"(> {cs.BUDGET_AGREEMENT}), rows MAE {res['rows_mae_px']:.4f} px "
                f"(< {cs.BUDGET_MAE_PX}); served dice {res['served_dice']:.4f}; weights "
                f"{res['weights_sha256']}", flush=True,
            )
    per_seed, ratios = {}, []
    for seed in args.seeds:
        res = cs.deeplab_step_errors(np.random.default_rng([seed, 12]), seed)
        binding = sorted(
            ((card / cpu, card, cpu, k) for card, cpu, _, _, k in res["tensors"]
             if card > cs.STEP_GRAD_RTOL),
            reverse=True,
        )
        over = max(
            card / max(cs.STEP_GRAD_RTOL, cs.DL_GRAD_CPU_FACTOR * cpu)
            for card, cpu, _, _, _ in res["tensors"]
        )
        needed = binding[0][0] if binding else 0.0
        ratios += [r[0] for r in binding]
        per_seed[seed] = {
            "needed_factor": needed,
            "worst_of_allowance": over,
            "binding": [(k, card, cpu) for _, card, cpu, k in binding],
            "card_worst": max(t[0] for t in res["tensors"]),
            "cpu_worst": max(t[1] for t in res["tensors"]),
            "gate_flips_card": res["gate_flips_card"],
        }
        print(
            f"seed {seed}: worst card {per_seed[seed]['card_worst']:.3e}, CPU "
            f"{per_seed[seed]['cpu_worst']:.3e} of a tensor's max; {len(binding)} tensors above "
            f"{cs.STEP_GRAD_RTOL:g}, factor needed {needed:.3f}; at factor "
            f"{cs.DL_GRAD_CPU_FACTOR:g} the worst tensor is {over:.3f} of its allowance"
        )
        for ratio, card, cpu, k in binding[:4]:
            print(f"  {k}: card {card:.3e}, CPU {cpu:.3e}, ratio {ratio:.3f}")
    needed = [v["needed_factor"] for v in per_seed.values()]
    summary = {
        "seeds": args.seeds,
        "needed_factor_max": max(needed, default=None),
        "needed_factor_per_seed": needed,
        "ratio_quantiles": {
            q: float(np.quantile(ratios, q)) for q in (0.5, 0.9, 1.0)
        } if ratios else None,
        "binding_tensors": len(ratios),
        "bf16_budgets": budgets,
        "card": cs.card_line(),
    }
    print(json.dumps({"deeplab_gate": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary, "per_seed": per_seed}, indent=1))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
