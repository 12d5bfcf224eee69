#!/usr/bin/env python3
"""The export path of ``chip_smoke.py`` alone, on the card.

    python3 tools/torch_export_path_probe.py [--seed 0]

Builds the kernels (``chip_smoke.phase_environment``), runs the GPU tests
of the registered min-path operators and of the ``torch.export`` artifact
(``tests/test_torch_cuda.py -k "registered_operators or
exported_pipeline"``, with ``--noconftest`` since the card's machine has
no JAX), then ``chip_smoke.phase_export_path`` at full width: the bench's
U-Net and DeepLabV3+ saved as directory checkpoints, exported by the CLI
for the card, loaded and served through B1/B2, held bit for bit against
eager serving, with the artifacts' and eager ms per batch and the export
and load seconds. Last it prints the card's name and power limit. It
needs the card and imports nothing of JAX; a quick check of the deployment
surface before the whole ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
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
        print("torch_export_path_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(cs.phase_environment(), flush=True)
    t0 = time.perf_counter()
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         "tests/test_torch_cuda.py", "-k", "registered_operators or exported_pipeline"],
        cwd=str(REPO), capture_output=True, text=True,
    )
    print(tests.stdout[-3000:], tests.stderr[-2000:], flush=True)
    print(f"GPU tests {time.perf_counter() - t0:.1f} s, exit {tests.returncode}", flush=True)
    rng = np.random.default_rng(args.seed)
    model = cs.build_unet(args.seed)
    volume = cs.layered_bscans(rng, cs.VOLUME, cs.H, cs.W, cs.NUM_CLASSES)
    print(cs.phase_export_path(model, args.seed, volume))
    print(cs.card_line())
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
