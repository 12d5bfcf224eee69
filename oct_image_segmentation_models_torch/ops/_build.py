"""Build the port's CUDA kernels from ``csrc/*.cu`` and load them.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/torch_kernels/`` at the repo root,
named by a hash of the source and the flags so an edited source is never
served a stale library. The libraries load with ``ctypes``. Nothing is
built while a module is imported: the first launch of a kernel builds
it, or :func:`build_all` builds every kernel at once, one ``nvcc`` per
source, all started together. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()


def kernel_names() -> list:
    """Names of every kernel source in ``csrc/`` (``minpath`` for
    ``csrc/minpath.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
        "built from source at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(process, tmp, out)`` or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one build; returns the compiler's output (register and
    shared-memory use from ``-Xptxas -v``). Raises if it failed."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    tmp.replace(out)
    return log


def build_all() -> dict:
    """Build every kernel in ``csrc/`` in parallel; returns the compiler
    output per kernel name."""
    with _lock:
        started = {name: _start(name) for name in kernel_names()}
        logs = {}
        errors = []
        for name, st in started.items():
            try:
                logs[name] = _finish(name, st)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    with _lock:
        _finish(name, _start(name))
    return ctypes.CDLL(str(library_path(name)))
