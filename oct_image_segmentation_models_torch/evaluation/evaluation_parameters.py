"""Evaluation configuration, counterpart of the JAX package's
``evaluation/evaluation_parameters.py``: validation raises, and the model
is loaded at construction on ``device`` (None means CUDA)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

from ..common import EVALUATION_METRICS, host_pool
from ..common.model_io import load_model_and_config


class EvaluationSaveParams:
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


class EvaluationParameters:
    def __init__(
        self,
        model_path: Path,
        mlflow_tracking_uri: Optional[str],
        mlflow_run_uuid: Optional[str],
        test_dataset_path: Path,
        save_foldername: Path,
        save_params: EvaluationSaveParams,
        graph_search: bool,
        metrics: List[str],
        gsgrad=1,
        dice_errors: bool = True,
        binarize: bool = True,
        bg_ilm: bool = True,
        bg_csi: bool = False,
        batch_size: int = 8,
        num_workers="auto",
        minpath_tie_parity: str = "fast",
        compute_dtype: str = "float32",
        device=None,
    ):
        self.model_path = model_path
        self.mlflow_tracking_uri = mlflow_tracking_uri
        self.mlflow_run_uuid = mlflow_run_uuid
        self.test_dataset_path = Path(test_dataset_path)
        self.binarize = binarize
        self.save_params = save_params
        self.graph_search = graph_search
        if not set(metrics).issubset(EVALUATION_METRICS):
            raise ValueError(
                f"Some of the provided metrics are invalid. Provided "
                f"metrics: {metrics}."
            )
        self.metrics = metrics
        self.gsgrad = gsgrad
        self.dice_errors = dice_errors
        self.bg_ilm = bg_ilm
        self.bg_csi = bg_csi
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size
        # Per-image metrics and artifacts in a spawn process pool; 0 or 1
        # is serial in process, "auto" is min(4, cpu_count - 1).
        self.num_workers = host_pool.resolve_num_workers(num_workers)
        if minpath_tie_parity not in ("exact", "fast"):
            raise ValueError(
                f"minpath_tie_parity must be 'exact' or 'fast', got "
                f"{minpath_tie_parity!r}"
            )
        self.minpath_tie_parity = minpath_tie_parity
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{compute_dtype!r}"
            )
        self.compute_dtype = compute_dtype
        self.save_foldername = Path(save_foldername)
        self.device = device
        self.loaded_model, self.model_config = load_model_and_config(
            model_path,
            mlflow_tracking_uri=mlflow_tracking_uri,
            mlflow_run_uuid=mlflow_run_uuid,
            device=device,
        )
        self.num_classes = self.loaded_model.output_classes
