"""Ahead-of-time deployment artifacts for the inference pipeline,
counterpart of the JAX package's ``common/export.py``.

The whole fused chain of :func:`..ops.inference.make_fused_pipeline`
(preprocess -> forward -> softmax and argmax -> boundary maps -> min-path
-> uint16 rows) is traced with ``torch.export.export``, the weights
embedded in the program. The artifact runs with no model source, no model
class and no checkpoint: :func:`load_exported_pipeline` needs PyTorch, the
bytes and :mod:`..ops.minpath_ops`, whose import registers the min-path
operators that the program calls.

Where the JAX package pins its plain XLA min-path, to keep a Pallas custom
call out of StableHLO, the program here holds the registered operators
``octseg::minpath_delineate[_s2d]`` in the tie mode asked for: on the card
they run the hand-written kernels B1/B2, on the CPU their plain versions.

The container is one zip file that needs no h5py: ``metadata.json`` (the
JAX package's keys, ``torch_version`` in place of ``jax_version``) and one
``torch.export.save`` program per platform, ``program_<platform>.pt2``,
each traced on its own device, so that no device constant of one platform
is in the other's program.
"""

from __future__ import annotations

import copy
import io
import json
import zipfile
from pathlib import Path

import torch

from .._device import float32_precision, resolve_device

EXPORT_FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")

_METADATA = "metadata.json"


def _program_name(platform: str) -> str:
    return f"program_{platform}.pt2"


def export_inference_pipeline(
    model_path,
    out_path,
    *,
    image_height: int = None,
    image_width: int = None,
    batch_size: int = 8,
    with_graph_search: bool = True,
    return_maps: bool = True,
    bg_ilm: bool = True,
    bg_csi: bool = False,
    max_grad: int = 1,
    minpath_tie_parity: str = "fast",
    optimize: bool = True,
    compute_dtype: str = "float32",
    platforms=PLATFORMS,
    mlflow_tracking_uri=None,
    mlflow_run_uuid=None,
    device=None,
) -> Path:
    """Export a trained model's fused inference pipeline to ``out_path``.

    ``image_height``/``image_width`` default to the geometry in the model
    config. ``optimize=True`` exports the s2d forward of an eligible U-Net
    (or the BN-folded DeepLabV3+), as ``VolumeSegmenter`` serves them.
    ``batch_size=None`` exports a symbolic batch (``torch.export.Dim``):
    one artifact then serves any batch of at least one. ``platforms`` takes
    ``"cpu"`` and ``"cuda"``; ``"cuda"`` needs a card and raises without
    one. The checkpoint is loaded on ``device`` (None means CUDA) and a
    copy of the pipeline is traced on each platform's device. Returns the
    written path."""
    from ..models import get_model_class
    from ..ops.inference import FusedPipeline, select_optimized_forward
    from .model_io import load_model_and_config

    platforms = tuple(platforms)
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {platforms}")
    for platform in platforms:
        resolve_device(platform)  # "cuda" without a card raises here
    loaded, model_config = load_model_and_config(
        model_path,
        mlflow_tracking_uri=mlflow_tracking_uri,
        mlflow_run_uuid=mlflow_run_uuid,
        device=device,
    )
    height = image_height or model_config.get("image_height")
    width = image_width or model_config.get("image_width")
    channels = model_config.get("input_channels", 1)
    if not height or not width:
        raise ValueError(
            "image_height/image_width must be given when the model config "
            "records no geometry"
        )
    container = get_model_class(loaded.name)(
        **{**model_config, "image_height": height, "image_width": width}
    )
    model_div = container.spatial_divisor
    if height % model_div or width % model_div:
        raise ValueError(
            f"export geometry {height}x{width} must be a multiple of "
            f"{model_div} (the model's spatial downsampling factor)"
        )
    forward, kind = select_optimized_forward(
        loaded.module, compute_dtype=compute_dtype, optimize=optimize
    )
    chain = FusedPipeline(
        forward.eval(),
        container.get_preprocess_input_fn(),
        s2d_labels=kind == "s2d",
        num_classes=loaded.output_classes,
        bg_ilm=bg_ilm,
        bg_csi=bg_csi,
        max_grad=max_grad,
        with_graph_search=with_graph_search,
        minpath_tie_parity=minpath_tie_parity,
        return_maps=return_maps,
    )
    # A symbolic batch is traced at 2: torch.export specialises a
    # dimension of size 1.
    example = (batch_size or 2, height, width, channels)
    dynamic = None if batch_size else ({0: torch.export.Dim("batch", min=1)},)
    programs = {}
    for platform in platforms:
        device = torch.device(platform)
        images = torch.zeros(example, dtype=torch.uint8, device=device)
        with torch.no_grad():
            program = torch.export.export(
                copy.deepcopy(chain).to(device), (images,), dynamic_shapes=dynamic
            )
        buf = io.BytesIO()
        torch.export.save(program, buf)
        programs[platform] = buf.getvalue()

    metadata = {
        "format_version": EXPORT_FORMAT_VERSION,
        "model_name": loaded.name,
        "model_config": model_config,
        "input_shape": [batch_size, height, width, channels],
        "input_dtype": "uint8",
        "platforms": list(platforms),
        "with_graph_search": with_graph_search,
        "return_maps": return_maps,
        "bg_ilm": bg_ilm,
        "bg_csi": bg_csi,
        "max_grad": max_grad,
        "minpath_tie_parity": minpath_tie_parity,
        "optimized_forward": kind,
        "compute_dtype": compute_dtype,
        "torch_version": torch.__version__,
    }
    out_path = Path(out_path)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(_METADATA, json.dumps(metadata))
        for platform, blob in programs.items():
            zf.writestr(_program_name(platform), blob)
    return out_path


def _is_integer_dtype(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


class ExportedPipeline:
    """A loaded deployment artifact.

    Called with a ``(B, H, W, C)`` batch of raw pixels (the exported shape;
    any B >= 1 for a symbolic batch), a numpy array or a tensor, it returns
    ``(labels u8, boundary maps u8 | None, rows u16 | None)`` on its
    device, the :func:`..ops.inference.make_fused_pipeline` contract.
    ``metadata`` is the export-time record."""

    def __init__(self, program: torch.export.ExportedProgram, metadata: dict, device):
        self.metadata = metadata
        self.device = device
        self._module = program.module()

    @property
    def input_shape(self):
        return tuple(self.metadata["input_shape"])

    def __call__(self, images_u8):
        images = torch.as_tensor(images_u8)  # no copy of a numpy batch
        expected = self.input_shape
        got = tuple(images.shape)
        fixed_ok = got == expected
        # A symbolic batch records a null batch entry: any batch >= 1 with
        # the exported geometry is valid.
        symbolic_ok = (
            expected[0] is None
            and len(got) == len(expected)
            and got[0] >= 1
            and got[1:] == expected[1:]
        )
        if not (fixed_ok or symbolic_ok):
            raise ValueError(
                f"exported pipeline was lowered for input shape {expected}, "
                f"got {got}; re-export with the desired batch/geometry"
            )
        if images.dtype != torch.uint8:
            # The artifact applies the preprocessing (x/255 and so on) itself
            # and takes RAW pixels: a cast of normalised floats would give
            # zeros, so only integers that uint8 holds are taken.
            if not _is_integer_dtype(images.dtype):
                raise ValueError(
                    f"exported pipeline takes raw uint8 images (it applies the "
                    f"model's preprocessing itself), got dtype {images.dtype}; "
                    "pass the unnormalized pixel values"
                )
            lo, hi = int(images.min()), int(images.max())
            if lo < 0 or hi > 255:
                raise ValueError(
                    f"integer image values outside [0, 255] (min {lo}, max {hi}) "
                    "cannot be represented as uint8 pixels"
                )
            images = images.to(torch.uint8)
        images = images.to(self.device, non_blocking=True)
        # The precision switches are process globals that the program does
        # not hold: the card's program serves in full float32, as eager
        # serving does.
        with torch.inference_mode(), float32_precision():
            return self._module(images)


def load_exported_pipeline(path, device=None) -> ExportedPipeline:
    """Load an artifact written by :func:`export_inference_pipeline`, with
    the program of ``device``'s platform (None means CUDA)."""
    from ..ops import minpath_ops  # noqa: F401  (registers the operators)

    device = resolve_device(device)
    try:
        zf = zipfile.ZipFile(path)
    except (zipfile.BadZipFile, IsADirectoryError) as exc:
        raise ValueError(f"{path} is not an octseg export artifact (not a zip file)") from exc
    with zf:
        names = set(zf.namelist())
        if _METADATA not in names:
            raise ValueError(
                f"{path} is not an octseg export artifact (missing {_METADATA!r})"
            )
        metadata = json.loads(zf.read(_METADATA))
        version = metadata.get("format_version")
        if version != EXPORT_FORMAT_VERSION:
            raise ValueError(
                f"unsupported export format version {version} "
                f"(this build reads version {EXPORT_FORMAT_VERSION})"
            )
        name = _program_name(device.type)
        if name not in names:
            raise ValueError(
                f"{path} holds no program for {device.type!r} (exported for "
                f"{metadata.get('platforms')})"
            )
        program = torch.export.load(io.BytesIO(zf.read(name)))
    return ExportedPipeline(program, metadata, device)
