"""The port's backend probe (``common/tunnel.py``) gives the JAX
package's three outcomes: ``("up", n)`` from a fresh interpreter,
``("error", 0)`` when the probe fails and ``("hang", 0)`` when it
outlives its timeout (``subprocess.run`` patched for those two)."""

import subprocess

import torch

from oct_image_segmentation_models_torch.common import tunnel

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)


def test_probe_reports_this_hosts_cards():
    assert tunnel.probe_backend(probe_timeout_s=120.0) == ("up", torch.cuda.device_count())


def test_probe_reports_a_hang(monkeypatch):
    def hang(*args, timeout=None, **kwargs):
        raise subprocess.TimeoutExpired(args[0], timeout)

    monkeypatch.setattr(tunnel.subprocess, "run", hang)
    assert tunnel.probe_backend(probe_timeout_s=0.5) == ("hang", 0)


def test_probe_reports_an_error(monkeypatch):
    for returncode, stdout in ((1, "Traceback ..."), (0, ""), (0, "no count\n")):
        monkeypatch.setattr(
            tunnel.subprocess, "run",
            lambda *a, rc=returncode, out=stdout, **k: subprocess.CompletedProcess(a[0], rc, out, ""),
        )
        assert tunnel.probe_backend() == ("error", 0), (returncode, stdout)
