"""Prediction workflow, counterpart of the JAX package's
``prediction/prediction.py``.

:func:`run_pipeline` runs inference, boundary-map conversion and the
min-path batched on the device through
:class:`..ops.inference.StagedPipeline` and copies each batch's outputs
to the host. :func:`predict` writes per image the JAX package's files
(``prediction_info.hdf5``, CSVs, PNGs, ``graph_search_prediction_info.hdf5``)
with the same HDF5 keys, attributes and dtypes. Per-image phase times are
the batch's time divided by the batch that ran.

HDF5 files are written through :mod:`..common.h5`, and matplotlib is
imported only by the functions that draw, so the workflow runs on a
machine that has neither h5py nor matplotlib.
"""

from __future__ import annotations

import logging as log
import time
from pathlib import Path
from typing import List, Union

import numpy as np
import torch

from .._device import resolve_device
from ..common import h5, host_pool, plotting, utils
from ..models import get_model_class
from ..ops.inference import StagedPipeline
from .prediction_parameters import PredictionParams


class PredictionOutput:
    def __init__(
        self,
        image: np.ndarray,
        image_name: Path,
        image_output_dir: Path,
        predicted_labels: np.ndarray,
        categorical_pred: np.ndarray,
        boundary_maps: np.ndarray,
        gs_pred_segs: Union[np.ndarray, None],
    ) -> None:
        self.image = image
        self.image_name = image_name
        self.image_output_dir = image_output_dir
        self.predicted_labels = predicted_labels
        self.categorical_pred = categorical_pred
        self.boundary_maps = boundary_maps
        self.gs_pred_segs = gs_pred_segs


def _sync(device: torch.device) -> None:
    """Wait for the card, so that a host clock around a stage times the
    stage and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(*tensors):
    """Device tensors -> numpy arrays (None stays None)."""
    return [None if t is None else t.cpu().numpy() for t in tensors]


def _batched(n, batch_size):
    for start in range(0, n, batch_size):
        yield start, min(start + batch_size, n)


_PIPELINE_KEYS = (
    "predicted_labels",
    "categorical_pred",
    "boundary_maps",
    "gs_pred_segs",
    "gs_masks",
    "predict_times",
    "convert_times",
    "graph_times",
)


def run_pipeline(
    loaded_model,
    model_config: dict,
    images,
    batch_size: int,
    graph_search: bool,
    bg_ilm: bool = True,
    bg_csi: bool = False,
    max_grad: int = 1,
    minpath_tie_parity: str = "exact",
    compute_dtype: str = "float32",
    device=None,
):
    """Run the staged pipeline over all images on ``device`` (None means
    CUDA) -> per-image outputs as numpy and per-image phase times.

    ``images`` is a uniform ``(N, H, W, C)`` uint8 array, or a list (or
    object array) of ``(H, W, C)`` arrays of mixed shapes. Mixed shapes
    are bucketed by shape, each bucket runs the batched pipeline, and the
    outputs come back in input order as lists.

    A tail chunk is padded to the batch size (by repeating its last
    image) only when there are more images than one batch."""
    device = resolve_device(device)
    if isinstance(images, (list, tuple)) or (
        isinstance(images, np.ndarray) and images.dtype == object
    ):
        per_image = [np.asarray(im) for im in images]
        shapes = {im.shape for im in per_image}
        if len(shapes) == 1:
            images = np.stack(per_image)
        else:
            buckets: dict = {}
            for i, im in enumerate(per_image):
                buckets.setdefault(im.shape, []).append(i)
            n = len(per_image)
            merged = {key: [None] * n for key in _PIPELINE_KEYS}
            for idxs in buckets.values():
                sub = run_pipeline(
                    loaded_model,
                    model_config,
                    np.stack([per_image[i] for i in idxs]),
                    batch_size,
                    graph_search,
                    bg_ilm=bg_ilm,
                    bg_csi=bg_csi,
                    max_grad=max_grad,
                    minpath_tie_parity=minpath_tie_parity,
                    compute_dtype=compute_dtype,
                    device=device,
                )
                for key in _PIPELINE_KEYS:
                    vals = sub[key]
                    if vals is None:
                        continue
                    for pos, i in enumerate(idxs):
                        merged[key][i] = vals[pos]
            if not graph_search:
                merged["gs_pred_segs"] = None
                merged["gs_masks"] = None
            return merged

    container = get_model_class(loaded_model.name)(**model_config)
    pipeline = StagedPipeline(
        loaded_model.module,
        container.get_preprocess_input_fn(),
        bg_ilm=bg_ilm,
        bg_csi=bg_csi,
        max_grad=max_grad,
        minpath_tie_parity=minpath_tie_parity,
        compute_dtype=compute_dtype,
        device=device,
    )

    n = images.shape[0]
    if n == 0:
        raise ValueError(
            "run_pipeline requires at least one image (callers handle "
            "empty datasets before invoking the device pipeline)"
        )
    batch = batch_size
    labels_out, cat_out, maps_out, segs_out, masks_out = [], [], [], [], []
    predict_times, convert_times, graph_times = [], [], []

    for start, stop in _batched(n, batch):
        chunk = images[start:stop]
        if chunk.shape[0] < batch and n > batch:
            pad = batch - chunk.shape[0]
            chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, axis=0)])
        chunk = torch.from_numpy(np.ascontiguousarray(chunk))
        if device.type == "cuda":
            chunk = chunk.pin_memory()

        t0 = time.perf_counter()
        probs = pipeline.predict_probs(chunk)
        _sync(device)
        t1 = time.perf_counter()
        argmax_pred, categorical, maps = pipeline.convert(probs)
        _sync(device)
        t2 = time.perf_counter()
        delins, masks = pipeline.graph_search(maps) if graph_search else (None, None)
        _sync(device)
        t3 = time.perf_counter()

        real = stop - start
        # The device ran the whole (padded) chunk, so a padded tail's
        # images get the chunk's time divided by the chunk's size.
        ran = chunk.shape[0]
        labels, cat, maps, delins, masks = to_host(
            argmax_pred, categorical, maps, delins, masks
        )
        labels_out.append(labels[:real])
        cat_out.append(cat[:real])
        maps_out.append(maps[:real])
        if delins is not None:
            segs_out.append(delins[:real])
            masks_out.append(masks[:real])
        predict_times += [(t1 - t0) / ran] * real
        convert_times += [(t2 - t1) / ran] * real
        graph_times += [(t3 - t2) / ran] * real

    return {
        "predicted_labels": np.concatenate(labels_out),
        "categorical_pred": np.concatenate(cat_out),
        "boundary_maps": np.concatenate(maps_out),
        "gs_pred_segs": np.concatenate(segs_out) if segs_out else None,
        "gs_masks": np.concatenate(masks_out) if masks_out else None,
        "predict_times": predict_times,
        "convert_times": convert_times,
        "graph_times": graph_times,
    }


def predict(predict_params: PredictionParams) -> List[PredictionOutput]:
    dataset = predict_params.dataset
    # Mixed image shapes stay a list; a uniform dataset stacks into one
    # array.
    try:
        predict_images = np.asarray(dataset.images)
        if predict_images.dtype == object:
            predict_images = [np.asarray(im) for im in dataset.images]
    except ValueError:  # inhomogeneous shapes refuse to stack
        predict_images = [np.asarray(im) for im in dataset.images]
    predict_image_names = dataset.image_names
    predict_image_output_dirs = dataset.image_output_dirs

    save_predict_config_file(predict_params)

    if len(predict_images) == 0:
        return []

    results = run_pipeline(
        predict_params.loaded_model,
        predict_params.model_config,
        predict_images,
        predict_params.batch_size,
        predict_params.graph_search,
        minpath_tie_parity=predict_params.minpath_tie_parity,
        compute_dtype=predict_params.compute_dtype,
        device=predict_params.device,
    )

    # The per-image artifacts are host work; tasks carry a small picklable
    # context, not PredictionParams (which holds the model).
    ctx = _PredSaveContext(
        model_path=predict_params.model_path,
        save_params=predict_params.save_params,
        col_error_range=predict_params.col_error_range,
        graph_search=predict_params.graph_search,
        col_error_range_explicit=predict_params.col_error_range_explicit,
    )
    tasks = []
    for i, (image_name, image_output_dir) in enumerate(
        zip(predict_image_names, predict_image_output_dirs)
    ):
        image_output_dir = Path(image_output_dir)
        image_output_dir.mkdir(parents=True, exist_ok=True)
        task = {
            "ind": i,
            "ctx": ctx,
            "image": predict_images[i],
            "image_name": image_name,
            "output_dir": image_output_dir,
            "predicted_labels": results["predicted_labels"][i],  # (H, W)
            "categorical_pred": results["categorical_pred"][i],  # (C, H, W)
            "boundary_maps": results["boundary_maps"][i],  # (C-1, H, W)
            "predict_time": results["predict_times"][i],
            "convert_time": results["convert_times"][i],
        }
        if predict_params.graph_search:
            task["gs_pred_segs"] = results["gs_pred_segs"][i]  # (C-1, W)
            task["gs_mask"] = results["gs_masks"][i]  # (H, W)
            task["graph_time"] = results["graph_times"][i]
        tasks.append(task)

    host_pool.map_host_tasks(_save_prediction_image, tasks, predict_params.num_workers)

    return [
        PredictionOutput(
            image=task["image"],
            image_name=task["image_name"],
            image_output_dir=task["output_dir"],
            predicted_labels=task["predicted_labels"],
            categorical_pred=task["categorical_pred"],
            boundary_maps=task["boundary_maps"],
            gs_pred_segs=task.get("gs_pred_segs"),
        )
        for task in tasks
    ]


class _PredSaveContext:
    """The picklable part of PredictionParams that the savers read."""

    def __init__(self, model_path, save_params, col_error_range,
                 graph_search, col_error_range_explicit):
        self.model_path = model_path
        self.save_params = save_params
        self.col_error_range = col_error_range
        self.graph_search = graph_search
        self.col_error_range_explicit = col_error_range_explicit


def _save_prediction_image(task: dict) -> None:
    """Artifacts of one image (numpy, the HDF5 layer and matplotlib only)."""
    ctx = task["ctx"]
    log.info(f"Saving prediction artifacts for image {task['ind']}: "
             f"{task['image_name']}")
    save_image_prediction_results(
        ctx,
        task["image"],
        task["image_name"],
        task["predicted_labels"],
        task["categorical_pred"],
        task["boundary_maps"],
        task["predict_time"],
        task["convert_time"],
        task["output_dir"],
    )
    if ctx.graph_search:
        save_graph_based_prediction_results(
            ctx,
            task["image"],
            task["image_name"],
            task["gs_mask"],
            task["gs_pred_segs"],
            task["graph_time"],
            task["output_dir"],
        )


def save_predict_config_file(predict_params: PredictionParams):
    with h5.File(
        predict_params.config_output_dir / Path("prediction_params.hdf5"), "w"
    ) as config_file:
        config_file.attrs["model_filename"] = np.array(
            str(predict_params.model_path), dtype="S1000"
        )
        config_file.attrs["error_col_inc_range"] = np.array(
            (
                predict_params.col_error_range[0],
                predict_params.col_error_range[-1],
            )
        )


def save_image_prediction_results(
    pred_params,  # PredictionParams or any object with .save_params/.model_path
    predict_image: np.ndarray,
    image_name: Path,
    predicted_labels: np.ndarray,
    categorical_pred: np.ndarray,
    boundary_maps: np.ndarray,
    predict_time: float,
    convert_time: float,
    output_dir: Path,
):
    with h5.File(output_dir / Path("prediction_info.hdf5"), "w") as hdf5_file:
        if pred_params.save_params.categorical_pred:
            hdf5_file.create_dataset(
                "categorical_pred", data=categorical_pred, dtype="uint8"
            )
            if pred_params.save_params.png_images:
                for map_ind in range(len(categorical_pred)):
                    plotting.save_image_plot(
                        categorical_pred[map_ind],
                        output_dir / Path(f"categorical_pred_{map_ind}.png"),
                        cmap="Blues",
                    )

        np.savetxt(
            output_dir / Path("segmentation_map.csv"),
            predicted_labels,
            fmt="%d",
            delimiter=",",
        )

        if pred_params.save_params.predicted_labels:
            hdf5_file.create_dataset(
                "predicted_labels", data=predicted_labels, dtype="uint8"
            )
            if pred_params.save_params.png_images:
                plotting.save_image_plot(
                    predicted_labels,
                    output_dir / Path("segmentation_map.png"),
                    cmap=plotting.region_cmap(len(categorical_pred)),
                )

        if pred_params.save_params.boundary_maps:
            hdf5_file.create_dataset("boundary_maps", data=boundary_maps, dtype="uint8")

        hdf5_file.create_dataset("raw_image", data=predict_image, dtype="uint8")

        if plotting.available():
            plotting.save_image_plot(
                predict_image,
                output_dir / Path("raw_image.png"),
                cmap=None if predict_image.shape[2] == 3 else "gray",
                vmin=0,
                vmax=255,
            )

        hdf5_file.attrs["model_filename"] = np.array(
            str(pred_params.model_path), dtype="S1000"
        )
        hdf5_file.attrs["image_name"] = np.array(str(image_name), dtype="S1000")
        hdf5_file.attrs["timestamp"] = np.array(utils.get_timestamp(), dtype="S1000")
        hdf5_file.attrs["predict_time"] = np.array(predict_time)
        hdf5_file.attrs["convert_time"] = convert_time


def save_graph_based_prediction_results(
    predict_params,  # PredictionParams or any object with .model_path,
    #                  .col_error_range and .col_error_range_explicit
    predict_image: np.ndarray,
    image_name: Path,
    gs_prediction_label: np.ndarray,
    gs_pred_segs: np.ndarray,
    graph_time: float,
    output_dir: Path,
):
    num_classes = gs_pred_segs.shape[0] + 1
    with h5.File(
        output_dir / Path("graph_search_prediction_info.hdf5"), "w"
    ) as hdf5_file:
        np.savetxt(
            output_dir / Path("gs_boundaries.csv"),
            gs_pred_segs,
            delimiter=",",
            fmt="%d",
        )
        np.savetxt(
            output_dir / Path("gs_segmentation_map.csv"),
            gs_prediction_label,
            fmt="%d",
            delimiter=",",
        )

        hdf5_file.create_dataset("gs_pred_segs", data=gs_pred_segs, dtype="uint16")
        hdf5_file.create_dataset(
            "gs_predicted_labels", data=gs_prediction_label, dtype="uint8"
        )

        if plotting.available():
            plotting.save_image_plot(
                gs_prediction_label,
                output_dir / Path("gs_predicted_segmentation_map.png"),
                cmap=plotting.region_cmap(num_classes),
            )
            # A defaulted column range is each image's full width (images may
            # differ in width); an explicit one is clamped to this image's.
            # An explicit range that starts beyond this image's width plots
            # the full width, as the JAX package does.
            width = gs_pred_segs.shape[1]
            if not predict_params.col_error_range_explicit:
                column_range = range(width)
            else:
                cr = predict_params.col_error_range
                start, stop = cr[0], cr[-1] + 1
                column_range = (
                    range(width) if start >= width else range(start, min(stop, width))
                )
            plotting.save_segmentation_plot(
                predict_image,
                "gray",
                output_dir / Path("gs_predicted_boundaries_ovelay_plot.png"),
                gs_pred_segs,
                predictions=None,
                column_range=column_range,
            )

        hdf5_file.attrs["model_filename"] = np.array(
            str(predict_params.model_path), dtype="S1000"
        )
        hdf5_file.attrs["image_name"] = np.array(str(image_name), dtype="S1000")
        hdf5_file.attrs["timestamp"] = np.array(utils.get_timestamp(), dtype="S1000")
        hdf5_file.attrs["graph_time"] = np.array(graph_time)
