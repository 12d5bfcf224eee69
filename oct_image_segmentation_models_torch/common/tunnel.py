"""Timeout-bounded backend probe, counterpart of the JAX package's
``common/tunnel.py``.

A process that initialises the card's runtime on a host where the driver
is wedged can block for good. Probing in a fresh interpreter under a hard
timeout lets a long-lived entry point (a bench, a smoke run) learn the
backend state without risking its own first initialisation. The probe
only reports: no caller falls back to the CPU on its answer.
"""

from __future__ import annotations

import subprocess
import sys

__all__ = ["probe_backend"]

_PROBE = "import torch; print(torch.cuda.device_count())"


def probe_backend(probe_timeout_s: float = 120.0) -> tuple[str, int]:
    """Classify the backend state from a fresh interpreter.

    Returns ``(mode, device_count)``:

    - ``("up", n)``: ``torch.cuda.device_count()`` returned ``n`` (0 on a
      host without a card);
    - ``("error", 0)``: the probe failed fast (an import or driver error);
      this process may go on and surface the real exception;
    - ``("hang", 0)``: the probe blocked past the timeout; initialising
      the runtime in this process would block too.
    """
    try:
        out = subprocess.run(
            [sys.executable, "-c", _PROBE],
            timeout=probe_timeout_s,
            capture_output=True,
            text=True,
        )
    except subprocess.TimeoutExpired:
        return "hang", 0
    if out.returncode != 0:
        return "error", 0
    try:
        return "up", int(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return "error", 0
