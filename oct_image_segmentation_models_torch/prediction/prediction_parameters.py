"""Prediction configuration, counterpart of the JAX package's
``prediction/prediction_parameters.py``: the model is loaded at
construction, on ``device`` (None means CUDA), and ``num_classes`` comes
from it."""

from __future__ import annotations

from pathlib import Path, PurePosixPath
from typing import Union

from ..common import host_pool
from ..common.dataset import Dataset
from ..common.model_io import load_model_and_config


class PredictionSaveParams:
    def __init__(
        self,
        predicted_labels: bool = True,
        categorical_pred: bool = False,
        png_images: bool = True,
        boundary_maps: bool = True,
    ) -> None:
        self.predicted_labels = predicted_labels
        self.categorical_pred = categorical_pred
        self.png_images = png_images
        self.boundary_maps = boundary_maps


class PredictionParams:
    def __init__(
        self,
        model_path: Union[Path, PurePosixPath],
        mlflow_tracking_uri: Union[str, None],
        mlflow_run_uuid: Union[str, None],
        dataset: Dataset,
        config_output_dir: Path,
        save_params: PredictionSaveParams,
        graph_search: bool = False,
        trim_maps: bool = False,
        trim_ref_ind: int = 0,
        trim_window: tuple = (0, 0),
        col_error_range: tuple = None,
        batch_size: int = 8,
        minpath_tie_parity: str = "fast",
        compute_dtype: str = "float32",
        num_workers="auto",
        device=None,
    ) -> None:
        self.model_path = model_path
        self.mlflow_tracking_uri = mlflow_tracking_uri
        self.mlflow_run_uuid = mlflow_run_uuid
        self.dataset = dataset
        self.device = device
        self.loaded_model, self.model_config = load_model_and_config(
            model_path,
            mlflow_tracking_uri=mlflow_tracking_uri,
            mlflow_run_uuid=mlflow_run_uuid,
            device=device,
        )
        self.num_classes = self.loaded_model.output_classes
        self.config_output_dir = Path(config_output_dir)
        self.save_params = save_params
        self.graph_search = graph_search
        self.trim_maps = trim_maps
        self.trim_ref_ind = trim_ref_ind
        self.trim_window = trim_window
        # Device batch of the staged pipeline.
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size
        # "fast" (the default, as in JAX) is cost-optimal and differs from
        # the original heap only in the order of exact cost ties; "exact"
        # reproduces the heap's tie-breaks bit for bit.
        if minpath_tie_parity not in ("exact", "fast"):
            raise ValueError(
                f"minpath_tie_parity must be 'exact' or 'fast', got "
                f"{minpath_tie_parity!r}"
            )
        self.minpath_tie_parity = minpath_tie_parity
        # The working type of the forward; both run on every serving path.
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{compute_dtype!r}"
            )
        self.compute_dtype = compute_dtype
        # Worker processes of the per-image artifact phase (HDF5/CSV/PNG);
        # 0 or 1 is serial in process, "auto" is min(4, cpu_count - 1).
        self.num_workers = host_pool.resolve_num_workers(num_workers)

        self.col_error_range = col_error_range
        # With mixed image shapes, a defaulted range means "full width" of
        # each image, while an explicit range is clamped to each image's
        # width in its plots.
        self.col_error_range_explicit = col_error_range is not None
        if col_error_range is None:
            if len(dataset.images) == 0:
                raise ValueError(
                    "PredictionParams needs a non-empty dataset (or an "
                    "explicit col_error_range) to derive the error column "
                    "range"
                )
            self.col_error_range = range(dataset.images[0].shape[1])  # width
