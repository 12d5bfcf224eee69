"""The port stands alone: it imports without JAX, never imports the JAX
package, defers h5py, matplotlib, MLflow, TensorBoard and every kernel
build to first use (the card's machine has neither h5py nor matplotlib),
and never falls back to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from oct_image_segmentation_models_torch import _device
from oct_image_segmentation_models_torch.ops import _build
from oct_image_segmentation_models_torch.ops import minpath

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "oct_image_segmentation_models_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "oct_image_segmentation_models_tpu")
# Imported only inside the functions that read or write files or track runs.
LAZY = ("h5py", "matplotlib", "mlflow", "tensorboard", "tensorboardX")

_IMPORT_ALL = """
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = {forbidden!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in FORBIDDEN:
        del sys.modules[mod]
sys.meta_path.insert(0, Block())

import oct_image_segmentation_models_torch as port
names = [port.__name__] + [
    m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=FORBIDDEN + LAZY)],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # Every module of the port, the workflows', training's, data
    # parallelism's (parallel/mesh.py, parallel/input_pipeline.py),
    # DeepLabV3+'s (models/resnet.py, models/deeplabv3plus.py) and the
    # deployment surface's (cli.py, common/export.py,
    # common/dataset_construction.py, ops/minpath_ops.py) included.
    assert int(out.stdout.strip().splitlines()[-1]) >= 57


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_deeplab_modules_are_scanned():
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    port = PORT.relative_to(REPO)
    assert {str(port / "models/resnet.py"), str(port / "models/deeplabv3plus.py")} <= scanned


def test_deployment_modules_are_scanned():
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    port = PORT.relative_to(REPO)
    assert {
        str(port / name)
        for name in ("cli.py", "common/export.py", "common/dataset_construction.py",
                     "ops/minpath_ops.py")
    } <= scanned


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_package_import(path):
    tree = ast.parse(path.read_text())
    top_level = set(id(node) for node in tree.body)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            if name.split(".")[0] in LAZY:
                assert id(node) not in top_level, f"{path}: {name} at module level"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_h5py_import(path):
    """HDF5 files go through common/h5.py: the card's machine has no
    h5py, and the path the CPU tests run must be the one that runs there."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(name.split(".")[0] == "h5py" for name in names), (path, names)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; device=None resolves to it")
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline
    from oct_image_segmentation_models_torch.prediction.streaming import (
        VolumeSegmenter,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve_device(None)
    container = get_model_class("unet")(
        input_channels=1, num_classes=3, image_height=8, image_width=8,
        start_neurons=2, pool_layers=1,
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        container.build_model()
    module = container.build_model(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fused_pipeline(module, container.get_preprocess_input_fn())
    loaded = LoadedModel("unet", module, container.get_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VolumeSegmenter(loaded, container.get_config())
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_cuda_backend_refuses_cpu_tensors():
    maps = torch.zeros((2, 5, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        minpath.delineate(maps, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        minpath.delineate_image_maps(maps, backend="cuda")


def test_kernel_build_is_deferred_and_raises_without_nvcc(monkeypatch, tmp_path):
    assert _build.kernel_names() == ["minpath", "s2d_enc_pair"]
    path = _build.library_path("minpath")
    assert path.parent == REPO / "build" / "torch_kernels"
    assert path.name.startswith("libminpath_") and path.suffix == ".so"
    if path.exists():
        pytest.skip("the kernel library is already built here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_float32_precision_restores_matmul_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with _device.float32_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
