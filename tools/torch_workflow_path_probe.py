#!/usr/bin/env python3
"""The workflow path of ``chip_smoke.py`` alone, on the card.

    python3 tools/torch_workflow_path_probe.py [--seed 0]

Builds the kernels (``chip_smoke.phase_environment``), then runs
``chip_smoke.phase_workflow_path`` at full width: a reference-schema
dataset written and read back through the port's HDF5 layer,
``train_model`` for 2 epochs with its defaults, ``model_final.hdf5``
through ``load_model_and_config``, ``VolumeSegmenter``, ``predict`` in
both tie modes and ``evaluate_model``, every file read back and every
path's rows held against the plain min-path. The train path's step is not
run here, so its time prints as nan. Last it prints the card's name and
power limit. It needs the card and imports nothing of JAX; a quick check
of the file-backed workflows before the whole ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_workflow_path_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(cs.phase_environment(), flush=True)
    out = cs.phase_workflow_path(args.seed, float("nan"))
    print(json.dumps({k: v for k, v in out.items() if k != "artifacts"}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
