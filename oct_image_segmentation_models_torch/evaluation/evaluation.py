"""Evaluation workflow, counterpart of the JAX package's
``evaluation/evaluation.py``.

Per-image artifacts (``evaluation_results.hdf5``, CSVs, PNGs,
``gs_evaluation_results.hdf5``) and the dataset-level aggregation
(``overall_evaluation_results.hdf5`` / ``.csv``) keep the JAX package's
file names, dataset keys, attributes, dtypes and statistics. Inference,
boundary-map conversion and the min-path run batched on the device
(:func:`..prediction.prediction.run_pipeline`); the Dice and
surface-distance metrics run on the host (numpy, scipy).

HDF5 files are read and written through :mod:`..common.h5`;
matplotlib is imported only by the functions that draw.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..common import (
    EVALUATION_METRIC_AVERAGE_SURFACE_DISTANCE,
    EVALUATION_METRIC_DICE_CLASSES,
    EVALUATION_METRIC_DICE_MACRO,
    EVALUATION_METRIC_DICE_MICRO,
    EVALUATION_METRIC_HAUSDORFF_DISTANCE,
    dataset_loader as dl,
    h5,
    host_pool,
    plotting,
    surface_distance as sd,
    utils as common_utils,
)
from ..min_path_processing import graph_search, utils
from ..prediction.prediction import run_pipeline
from .evaluation_parameters import EvaluationParameters

EVALUATION_RESULTS_FILENAME = "evaluation_results.hdf5"
GS_EVALUATION_RESULTS_FILENAME = "gs_evaluation_results.hdf5"
OVERALL_EVALUATION_RESULTS_FILENAME_HDF5 = "overall_evaluation_results.hdf5"
OVERALL_EVALUATION_RESULTS_FILENAME_CSV = "overall_evaluation_results.csv"

_SPACING = (0.01111111, 0.01111111)  # mm per pixel, as in the JAX package


class EvaluationOutput:
    def __init__(
        self,
        image: np.ndarray,
        image_name: Path,
        image_segments: np.ndarray,
        image_output_dir: Path,
        predicted_labels: np.ndarray,
        categorical_pred: np.ndarray,
        boundary_maps: np.ndarray,
        gs_pred_segs: Optional[np.ndarray],
        errors: Optional[np.ndarray],
        mean_abs_err: Optional[np.ndarray],
        mean_err: Optional[np.ndarray],
        abs_err_sd: Optional[np.ndarray],
        err_sd: Optional[np.ndarray],
    ) -> None:
        self.image = image
        self.image_name = image_name
        self.image_segments = image_segments
        self.image_output_dir = image_output_dir
        self.predicted_labels = predicted_labels
        self.categorical_pred = categorical_pred
        self.boundary_maps = boundary_maps
        self.gs_pred_segs = gs_pred_segs
        self.errors = errors
        self.mean_abs_err = mean_abs_err
        self.mean_err = mean_err
        self.abs_err_sd = abs_err_sd
        self.err_sd = err_sd


def _dice_classes(onehot_cf, pred_cf):
    """Per-class soft Dice, (C, H, W) class-first inputs -> (C,)."""
    axes = tuple(range(1, onehot_cf.ndim))
    intersect = (onehot_cf * pred_cf).sum(axis=axes)
    denom = (onehot_cf + pred_cf).sum(axis=axes)
    return (2.0 * intersect + 1e-5) / (denom + 1e-5)


def _dice_macro(onehot_cf, pred_cf, eps=1e-5):
    p = (pred_cf > 0.5).astype(np.float64)
    axes = tuple(range(1, onehot_cf.ndim))
    intersect = (onehot_cf * p).sum(axis=axes)
    denom = onehot_cf.sum(axis=axes) + p.sum(axis=axes)
    return np.mean((2.0 * intersect + eps) / (denom + eps))


def _dice_micro(onehot_cf, pred_cf):
    t = onehot_cf.ravel()
    p = (pred_cf.ravel() > 0.5).astype(np.float64)
    return 2.0 * (t * p).sum() / (t.sum() + p.sum())


def evaluate_model(eval_params: EvaluationParameters) -> List[EvaluationOutput]:
    with h5.File(eval_params.test_dataset_path, "r") as test_dataset_file:
        eval_images, eval_labels, eval_image_names = dl.load_testing_data(
            test_dataset_file
        )
    if eval_images.shape[0] == 0:
        raise ValueError(
            f"test dataset {eval_params.test_dataset_path} contains no "
            "test images — nothing to evaluate"
        )

    eval_image_output_dirs = [
        eval_params.save_foldername / Path(f"image_{i}")
        for i in range(eval_images.shape[0])
    ]

    # (N, num_boundaries, W): first row of each class per column.
    eval_segments = np.swapaxes(
        utils.generate_boundary(np.squeeze(eval_labels, axis=3), axis=1), 0, 1
    )

    num_classes = eval_params.num_classes
    save_eval_config_file(eval_params)

    results = run_pipeline(
        eval_params.loaded_model,
        eval_params.model_config,
        np.asarray(eval_images),
        eval_params.batch_size,
        eval_params.graph_search,
        bg_ilm=eval_params.bg_ilm,
        bg_csi=eval_params.bg_csi,
        max_grad=eval_params.gsgrad,
        minpath_tie_parity=eval_params.minpath_tie_parity,
        compute_dtype=eval_params.compute_dtype,
        device=eval_params.device,
    )

    # Per-image host work (metrics and artifacts) can run in a process
    # pool (EvaluationParameters.num_workers). Tasks carry numpy arrays
    # (dense labels, binarized predictions), so a worker computes what
    # the serial loop computes, bit for bit.
    ctx = _SaveContext(
        model_path=str(eval_params.model_path),
        save_params=eval_params.save_params,
        metrics=tuple(eval_params.metrics),
        graph_search=eval_params.graph_search,
        num_classes=num_classes,
    )
    tasks = []
    for ind in range(eval_images.shape[0]):
        eval_image_output_dir = eval_image_output_dirs[ind]
        os.makedirs(eval_image_output_dir, exist_ok=True)
        task = {
            "ind": ind,
            "ctx": ctx,
            "image": eval_images[ind],
            "labels_dense": eval_labels[ind, ..., 0],
            "image_name": eval_image_names[ind],
            "seg": eval_segments[ind],
            "output_dir": eval_image_output_dir,
            "predicted_labels": results["predicted_labels"][ind],
            "categorical_pred": results["categorical_pred"][ind],
            "predict_time": results["predict_times"][ind],
        }
        if eval_params.graph_search:
            task["gs_pred_segs"] = results["gs_pred_segs"][ind]
            task["gs_mask"] = results["gs_masks"][ind]
            task["graph_time"] = results["graph_times"][ind]
        tasks.append(task)

    gs_stats = host_pool.map_host_tasks(
        _evaluate_and_save_image, tasks, eval_params.num_workers
    )

    eval_outputs = []
    for ind, (task, stats) in enumerate(zip(tasks, gs_stats)):
        eval_outputs.append(
            EvaluationOutput(
                image=task["image"],
                image_name=task["image_name"],
                image_segments=task["seg"],
                image_output_dir=task["output_dir"],
                predicted_labels=task["predicted_labels"],
                categorical_pred=task["categorical_pred"],
                boundary_maps=results["boundary_maps"][ind],
                gs_pred_segs=task.get("gs_pred_segs"),
                errors=stats.get("errors"),
                mean_abs_err=stats.get("mean_abs_err"),
                mean_err=stats.get("mean_err"),
                abs_err_sd=stats.get("abs_err_sd"),
                err_sd=stats.get("err_sd"),
            )
        )

    _calc_overall_dataset_errors(eval_params, eval_image_names)
    return eval_outputs


class _SaveContext:
    """Picklable slice of EvaluationParameters for worker processes."""

    def __init__(self, model_path, save_params, metrics, graph_search,
                 num_classes):
        self.model_path = model_path
        self.save_params = save_params
        self.metrics = metrics
        self.graph_search = graph_search
        self.num_classes = num_classes


def _evaluate_and_save_image(task: dict) -> dict:
    """Metrics and artifacts of one image (numpy, scipy, the HDF5 layer
    and matplotlib only). Returns the graph-search error statistics for
    the EvaluationOutput."""
    ctx = task["ctx"]
    ind = task["ind"]
    num_classes = ctx.num_classes
    eval_image = task["image"]
    eval_image_name = task["image_name"]
    eval_seg = task["seg"]
    eval_image_output_dir = task["output_dir"]
    predicted_labels = task["predicted_labels"]
    categorical_pred = task["categorical_pred"]

    print(f"Evaluating image number: {ind + 1} ({eval_image_name})...")

    eval_label = np.eye(num_classes, dtype=np.float64)[
        task["labels_dense"].astype(np.int64)
    ]  # (H, W, C) one-hot
    eval_label_class_first = np.transpose(eval_label, (2, 0, 1))

    dice_classes = (
        _dice_classes(eval_label_class_first, categorical_pred)
        if EVALUATION_METRIC_DICE_CLASSES in ctx.metrics
        else None
    )
    dice_macro = (
        np.array(_dice_macro(eval_label_class_first, categorical_pred))
        if EVALUATION_METRIC_DICE_MACRO in ctx.metrics
        else None
    )
    dice_micro = (
        np.array(_dice_micro(eval_label_class_first, categorical_pred))
        if EVALUATION_METRIC_DICE_MICRO in ctx.metrics
        else None
    )

    if EVALUATION_METRIC_AVERAGE_SURFACE_DISTANCE in ctx.metrics:
        asd, asd_gt, asd_pred = [], [], []
        for class_idx in range(1, num_classes):  # skip background
            gt = eval_label[:, :, class_idx].astype(bool)
            pr = categorical_pred[class_idx].astype(bool)
            d_gt, d_pred = sd.average_surface_distance(gt, pr, _SPACING)
            asd_gt.append(d_gt)
            asd_pred.append(d_pred)
            asd.append((d_gt + d_pred) / 2.0)
        average_surface_distances = np.array(asd)
        average_surface_distances_gt_to_pred = np.array(asd_gt)
        average_surface_distances_pred_to_gt = np.array(asd_pred)
    else:
        average_surface_distances = None
        average_surface_distances_gt_to_pred = None
        average_surface_distances_pred_to_gt = None

    if EVALUATION_METRIC_HAUSDORFF_DISTANCE in ctx.metrics:
        hausdorff_distances = np.array(
            [
                sd.hausdorff_distance(
                    eval_label[:, :, class_idx].astype(bool),
                    categorical_pred[class_idx].astype(bool),
                    _SPACING,
                    percent=95,
                )
                for class_idx in range(1, num_classes)
            ]
        )
    else:
        hausdorff_distances = None

    _save_image_evaluation_results(
        ctx,
        eval_image,
        eval_image_name,
        eval_seg,
        predicted_labels,
        categorical_pred,
        task["labels_dense"],
        dice_classes,
        dice_macro,
        dice_micro,
        average_surface_distances,
        average_surface_distances_gt_to_pred,
        average_surface_distances_pred_to_gt,
        hausdorff_distances,
        task["predict_time"],
        eval_image_output_dir,
    )

    stats: dict = {}
    if ctx.graph_search:
        print("Running graph search, segmenting boundary maps...")
        start_graph_time = time.time()
        gs_pred_segs = task["gs_pred_segs"]  # (C-1, W)
        gs_eval_label = task["gs_mask"]  # (H, W)
        if eval_seg.shape[0] < gs_pred_segs.shape[0]:
            # a clear error instead of an IndexError in the worker pool:
            # a class the model predicts but the test labels never
            # contain has no true boundary to compare with
            raise ValueError(
                f"test labels define {eval_seg.shape[0]} boundaries but "
                f"the model predicts {gs_pred_segs.shape[0]}; boundary-"
                "error evaluation needs every predicted class present "
                "in the test labels"
            )
        errors = np.stack(
            [
                graph_search.calc_errors(gs_pred_segs[m], eval_seg[m])
                for m in range(gs_pred_segs.shape[0])
            ]
        )
        reconstructed_cf = np.eye(num_classes, dtype=np.float64)[
            gs_eval_label.astype(np.int64)
        ].transpose(2, 0, 1)  # (C, H, W)

        gs_dice_classes = (
            _dice_classes(eval_label_class_first, reconstructed_cf)
            if EVALUATION_METRIC_DICE_CLASSES in ctx.metrics
            else None
        )
        gs_dice_macro = (
            np.array(_dice_macro(eval_label_class_first, reconstructed_cf))
            if EVALUATION_METRIC_DICE_MACRO in ctx.metrics
            else None
        )
        gs_dice_micro = (
            np.array(_dice_micro(eval_label_class_first, reconstructed_cf))
            if EVALUATION_METRIC_DICE_MICRO in ctx.metrics
            else None
        )
        graph_time = task["graph_time"] + (time.time() - start_graph_time)

        (mean_abs_err, mean_err, abs_err_sd, err_sd) = (
            graph_search.calculate_overall_errors(errors)
        )

        _save_graph_based_evaluation_results(
            ctx,
            eval_image,
            eval_image_name,
            eval_seg,
            gs_eval_label,
            gs_pred_segs,
            gs_dice_classes,
            gs_dice_macro,
            gs_dice_micro,
            errors,
            mean_abs_err,
            mean_err,
            abs_err_sd,
            err_sd,
            graph_time,
            eval_image_output_dir,
        )
        stats = {
            "errors": errors,
            "mean_abs_err": mean_abs_err,
            "mean_err": mean_err,
            "abs_err_sd": abs_err_sd,
            "err_sd": err_sd,
        }
    else:
        print("Skipping graph search...")

    print(f"DONE image number: {ind + 1} ({eval_image_name})...")
    print("______________________________")
    return stats



def _save_csv(path, array):
    np.savetxt(path, array, fmt="%d", delimiter=",")


def _write_datasets(hdf5_file, specs):
    """Create HDF5 datasets from (name, data, dtype) triples, skipping
    None data (optional metrics)."""
    for name, data, dtype in specs:
        if data is not None:
            hdf5_file.create_dataset(name, data=data, dtype=dtype)


def _write_run_attrs(hdf5_file, eval_params, image_name, **extra):
    hdf5_file.attrs["model_filename"] = np.array(
        str(eval_params.model_path), dtype="S1000"
    )
    hdf5_file.attrs["image_name"] = np.array(str(image_name), dtype="S1000")
    hdf5_file.attrs["timestamp"] = np.array(
        common_utils.get_timestamp(), dtype="S1000"
    )
    for key, value in extra.items():
        hdf5_file.attrs[key] = np.array(value)


def _opt(transform, value):
    return None if value is None else transform(value)

def _save_image_evaluation_results(
    eval_params: "_SaveContext",
    eval_image: np.ndarray,
    image_name: Path,
    truth_label_segs: np.ndarray,
    predicted_labels: np.ndarray,
    categorical_pred: np.ndarray,
    eval_labels: np.ndarray,
    dice_classes: Optional[np.ndarray],
    dice_macro: Optional[np.ndarray],
    dice_micro: Optional[np.ndarray],
    average_surface_distances: Optional[np.ndarray],
    average_surface_distances_gt_to_pred: Optional[np.ndarray],
    average_surface_distances_pred_to_gt: Optional[np.ndarray],
    hausdorff_distances: Optional[np.ndarray],
    predict_time: float,
    output_dir: Path,
):
    save = eval_params.save_params
    num_classes = len(categorical_pred)
    (output_dir / "input_image_name.txt").write_text(str(image_name))
    _save_csv(output_dir / "predicted_segmentation_map.csv", predicted_labels)

    # eval_labels is the dense label map.
    _save_csv(output_dir / "ground_truth_segmentation_map.csv", eval_labels)

    with h5.File(output_dir / EVALUATION_RESULTS_FILENAME, "w") as f:
        _write_datasets(
            f,
            [
                (
                    "categorical_pred",
                    categorical_pred if save.categorical_pred else None,
                    "uint8",
                ),
                (
                    "predicted_segmentation_map",
                    predicted_labels if save.predicted_labels else None,
                    "uint8",
                ),
                ("raw_image", eval_image, "uint8"),
                ("eval_labels", eval_labels, "uint8"),
                ("raw_segs", truth_label_segs, "uint16"),
                (
                    EVALUATION_METRIC_DICE_CLASSES,
                    _opt(np.squeeze, dice_classes),
                    "float64",
                ),
                (
                    EVALUATION_METRIC_DICE_MACRO,
                    _opt(np.atleast_1d, dice_macro),
                    "float64",
                ),
                (
                    EVALUATION_METRIC_DICE_MICRO,
                    _opt(np.atleast_1d, dice_micro),
                    "float64",
                ),
                (
                    "average_surface_distances",
                    average_surface_distances,
                    "float64",
                ),
                (
                    "average_surface_distances_gt_to_pred",
                    average_surface_distances_gt_to_pred,
                    "float64",
                ),
                (
                    "average_surface_distances_pred_to_gt",
                    average_surface_distances_pred_to_gt,
                    "float64",
                ),
                ("hausdorff_distances", hausdorff_distances, "float64"),
            ],
        )
        _write_run_attrs(
            f, eval_params, image_name, predict_time=predict_time
        )

    if save.categorical_pred and save.png_images:
        for map_ind, class_map in enumerate(categorical_pred):
            plotting.save_image_plot(
                class_map,
                output_dir / f"categorical_pred_{map_ind}.png",
                cmap="Blues",
            )
    if save.predicted_labels and save.png_images:
        plotting.save_image_plot(
            predicted_labels,
            output_dir / "predicted_segmentation_map.png",
            cmap=plotting.region_cmap(num_classes),
        )
    if plotting.available():
        plotting.save_image_plot(
            eval_image,
            output_dir / "raw_image.png",
            cmap=None if eval_image.shape[2] == 3 else "gray",
            vmin=0,
            vmax=255,
        )
        plotting.save_image_plot(
            eval_labels,
            output_dir / "ground_truth_segmentation_map.png",
            cmap=plotting.region_cmap(num_classes),
        )
        plotting.save_segmentation_plot(
            eval_image,
            "gray",
            output_dir / "truth_plot.png",
            truth_label_segs,
            predictions=None,
            column_range=range(eval_image.shape[1]),
        )


def _save_graph_based_evaluation_results(
    eval_params: "_SaveContext",
    eval_image: np.ndarray,
    image_name: Path,
    truth_label_segs: np.ndarray,
    gs_eval_label: np.ndarray,
    gs_pred_segs: np.ndarray,
    gs_dice_classes: Optional[np.ndarray],
    gs_dice_macro: Optional[np.ndarray],
    gs_dice_micro: Optional[np.ndarray],
    errors: np.ndarray,
    mean_abs_err: np.ndarray,
    mean_err: np.ndarray,
    abs_err_sd: np.ndarray,
    err_sd: np.ndarray,
    graph_time: float,
    output_dir: Path,
):
    num_classes = gs_pred_segs.shape[0] + 1
    _save_csv(output_dir / "gs_boundaries.csv", gs_pred_segs)
    _save_csv(output_dir / "gs_predicted_segmentation_map.csv", gs_eval_label)

    with h5.File(output_dir / GS_EVALUATION_RESULTS_FILENAME, "w") as f:
        _write_datasets(
            f,
            [
                ("gs_pred_segs", gs_pred_segs, "uint16"),
                ("errors", errors, "float64"),
                ("mean_abs_err", mean_abs_err, "float64"),
                ("mean_err", mean_err, "float64"),
                ("abs_err_sd", abs_err_sd, "float64"),
                ("err_sd", err_sd, "float64"),
                (
                    EVALUATION_METRIC_DICE_CLASSES,
                    _opt(np.squeeze, gs_dice_classes),
                    "float64",
                ),
                (
                    EVALUATION_METRIC_DICE_MACRO,
                    _opt(np.atleast_1d, gs_dice_macro),
                    "float64",
                ),
                (
                    EVALUATION_METRIC_DICE_MICRO,
                    _opt(np.atleast_1d, gs_dice_micro),
                    "float64",
                ),
                ("gs_predicted_labels", gs_eval_label, "uint8"),
            ],
        )
        _write_run_attrs(f, eval_params, image_name, graph_time=graph_time)

    if plotting.available():
        plotting.save_image_plot(
            gs_eval_label,
            output_dir / "gs_predicted_segmentation_map.png",
            cmap=plotting.region_cmap(num_classes),
        )
        plotting.save_segmentation_plot(
            eval_image,
            "gray",
            output_dir / "gs_pred_and_truth_overlay_plot.png",
            truth_label_segs,
            gs_pred_segs,
            column_range=range(eval_image.shape[1]),
        )
        plotting.save_segmentation_plot(
            eval_image,
            "gray",
            output_dir / "gs_predicted_boundaries_ovelay_plot.png",
            gs_pred_segs,
            predictions=None,
            column_range=range(eval_image.shape[1]),
        )


def save_eval_config_file(eval_params: EvaluationParameters):
    eval_params.save_foldername.mkdir(parents=True, exist_ok=True)
    with h5.File(eval_params.save_foldername / Path("eval_params.hdf5"), "w") as f:
        f.attrs["model_filename"] = np.array(
            str(eval_params.model_path), dtype="S1000"
        )
        f.attrs["mlflow_tracking_uri"] = np.array(
            str(eval_params.mlflow_tracking_uri), dtype="S1000"
        )
        f.attrs["test_dataset_path"] = np.array(
            str(eval_params.test_dataset_path), dtype="S1000"
        )
        f.attrs["test_dataset_md5"] = np.array(
            common_utils.md5(eval_params.test_dataset_path), dtype="S1000"
        )
        f.attrs["gsgrad"] = np.array(eval_params.gsgrad)


def _calc_overall_dataset_errors(
    eval_params: EvaluationParameters, eval_image_names: List[Path]
):
    """Dataset-level aggregation (the JAX package's output keys,
    statistics and CSV lines)."""
    output_dir = eval_params.save_foldername
    graph_search_on = eval_params.graph_search
    metrics = eval_params.metrics

    def concat(name, hdf5_file, store):
        value = hdf5_file[name][:]
        store.setdefault(name, []).append(value)

    per_image = {}
    gs_per_image = {}
    dir_list = [
        Path(output_dir) / Path(f"image_{i}")
        for i in range(len(eval_image_names))
    ]
    for obj_name in dir_list:
        with h5.File(obj_name / EVALUATION_RESULTS_FILENAME, "r") as f:
            if EVALUATION_METRIC_DICE_CLASSES in metrics:
                concat(EVALUATION_METRIC_DICE_CLASSES, f, per_image)
            if EVALUATION_METRIC_DICE_MACRO in metrics:
                concat(EVALUATION_METRIC_DICE_MACRO, f, per_image)
            if EVALUATION_METRIC_DICE_MICRO in metrics:
                concat(EVALUATION_METRIC_DICE_MICRO, f, per_image)
            if EVALUATION_METRIC_AVERAGE_SURFACE_DISTANCE in metrics:
                concat("average_surface_distances", f, per_image)
                concat("average_surface_distances_gt_to_pred", f, per_image)
                concat("average_surface_distances_pred_to_gt", f, per_image)
            if EVALUATION_METRIC_HAUSDORFF_DISTANCE in metrics:
                concat("hausdorff_distances", f, per_image)

    if graph_search_on:
        for obj_name in dir_list:
            with h5.File(obj_name / GS_EVALUATION_RESULTS_FILENAME, "r") as f:
                concat("errors", f, gs_per_image)
                if EVALUATION_METRIC_DICE_CLASSES in metrics:
                    concat(EVALUATION_METRIC_DICE_CLASSES, f, gs_per_image)
                if EVALUATION_METRIC_DICE_MACRO in metrics:
                    concat(EVALUATION_METRIC_DICE_MACRO, f, gs_per_image)
                if EVALUATION_METRIC_DICE_MICRO in metrics:
                    concat(EVALUATION_METRIC_DICE_MICRO, f, gs_per_image)

    # Context-managed: an exception mid-aggregation closes both files.
    with h5.File(
        output_dir / OVERALL_EVALUATION_RESULTS_FILENAME_HDF5, "w"
    ) as save_file, open(
        output_dir / OVERALL_EVALUATION_RESULTS_FILENAME_CSV, "w"
    ) as save_textfile:
        save_file["image_names"] = np.array(
            [str(n) for n in eval_image_names], dtype="S1000"
        )

        def save_metric(metric_name: str, metric: np.ndarray):
            save_file[metric_name] = metric
            metric = metric.astype(np.float64)
            metric[metric == np.inf] = np.nan
            mean_metric = np.nanmean(metric, axis=0)
            sd_metric = np.nanstd(metric, axis=0)
            save_file[f"mean_{metric_name}"] = mean_metric
            save_file[f"sd_{metric_name}"] = sd_metric
            save_textfile.write(f"Mean {metric_name},")
            save_textfile.write(",".join([f"{e:.7f}" for e in np.atleast_1d(mean_metric)]) + "\n")
            save_textfile.write(f"SD {metric_name},")
            save_textfile.write(",".join([f"{e:.7f}" for e in np.atleast_1d(sd_metric)]) + "\n")

        def stacked(store, name):
            return np.stack(store[name])

        if EVALUATION_METRIC_DICE_CLASSES in metrics:
            save_metric(
                EVALUATION_METRIC_DICE_CLASSES,
                stacked(per_image, EVALUATION_METRIC_DICE_CLASSES),
            )
        if EVALUATION_METRIC_DICE_MACRO in metrics:
            save_metric(
                EVALUATION_METRIC_DICE_MACRO,
                stacked(per_image, EVALUATION_METRIC_DICE_MACRO),
            )
        if EVALUATION_METRIC_DICE_MICRO in metrics:
            save_metric(
                EVALUATION_METRIC_DICE_MICRO,
                stacked(per_image, EVALUATION_METRIC_DICE_MICRO),
            )
        if EVALUATION_METRIC_AVERAGE_SURFACE_DISTANCE in metrics:
            save_metric(
                "average_surface_distances",
                stacked(per_image, "average_surface_distances"),
            )
            save_metric(
                "average_surface_distances_gt_to_pred",
                stacked(per_image, "average_surface_distances_gt_to_pred"),
            )
            save_metric(
                "average_surface_distances_pred_to_gt",
                stacked(per_image, "average_surface_distances_pred_to_gt"),
            )
        if EVALUATION_METRIC_HAUSDORFF_DISTANCE in metrics:
            save_metric(
                "hausdorff_distances", stacked(per_image, "hausdorff_distances")
            )

        if graph_search_on:
            if EVALUATION_METRIC_DICE_CLASSES in metrics:
                save_metric(
                    f"gs_{EVALUATION_METRIC_DICE_CLASSES}",
                    stacked(gs_per_image, EVALUATION_METRIC_DICE_CLASSES),
                )
            if EVALUATION_METRIC_DICE_MACRO in metrics:
                save_metric(
                    f"gs_{EVALUATION_METRIC_DICE_MACRO}",
                    stacked(gs_per_image, EVALUATION_METRIC_DICE_MACRO),
                )
            if EVALUATION_METRIC_DICE_MICRO in metrics:
                save_metric(
                    f"gs_{EVALUATION_METRIC_DICE_MICRO}",
                    stacked(gs_per_image, EVALUATION_METRIC_DICE_MICRO),
                )

            errors = stacked(gs_per_image, "errors")  # (N, boundaries, W)
            mean_abs_errors_cols = np.nanmean(np.abs(errors), axis=0)
            mean_abs_errors_samples = np.nanmean(np.abs(errors), axis=2)
            sd_abs_errors_samples = np.nanstd(np.abs(errors), axis=2)
            mean_abs_errors = np.nanmean(mean_abs_errors_samples, axis=0)
            sd_abs_errors = np.nanstd(mean_abs_errors_samples, axis=0)
            median_abs_errors = np.nanmedian(mean_abs_errors_samples, axis=0)

            mean_errors_cols = np.nanmean(errors, axis=0)
            mean_errors_samples = np.nanmean(errors, axis=2)
            mean_errors = np.nanmean(mean_errors_samples, axis=0)
            sd_errors = np.nanstd(mean_errors_samples, axis=0)
            median_errors = np.nanmedian(mean_errors_samples, axis=0)

            save_file["mean_abs_errors_cols"] = mean_abs_errors_cols
            save_file["mean_abs_errors_samples"] = mean_abs_errors_samples
            save_file["mean_abs_errors"] = mean_abs_errors
            save_file["sd_abs_errors"] = sd_abs_errors
            save_file["median_abs_errors"] = median_abs_errors
            save_file["sd_abs_errors_samples"] = sd_abs_errors_samples

            save_file["mean_errors_cols"] = mean_errors_cols
            save_file["mean_errors_samples"] = mean_errors_samples
            save_file["mean_errors"] = mean_errors
            save_file["sd_errors"] = sd_errors
            save_file["median_errors"] = median_errors

            save_file["errors"] = errors

            save_textfile.write("Mean abs errors,")
            save_textfile.write(",".join([f"{e:.7f}" for e in mean_abs_errors]) + "\n")
            save_textfile.write("Mean errors,")
            save_textfile.write(",".join([f"{e:.7f}" for e in mean_errors]) + "\n")
            save_textfile.write("Median absolute errors,")
            save_textfile.write(",".join([f"{e:.7f}" for e in median_abs_errors]) + "\n")
            save_textfile.write("SD abs errors,")
            save_textfile.write(",".join([f"{e:.7f}" for e in sd_abs_errors]) + "\n")
            save_textfile.write("SD errors,")
            save_textfile.write(",".join([f"{e:.7f}" for e in sd_errors]) + "\n")

