"""Experiment tracking, counterpart of the JAX package's
``common/tracking.py``: MLflow when it is importable and
``MLflowParameters`` are given, else a ``LocalTracker`` that writes
``mlflow_params.json`` / ``mlflow_metrics.jsonl`` into the run folder.
``mlflow`` and the TensorBoard writers are imported inside the functions
that use them.
"""

from __future__ import annotations

import json
import logging as log
import os
from pathlib import Path
from typing import Optional

from .mlflow_parameters import MLflowParameters


class NullTracker:
    run_id = ""

    def start_run(self):
        """Begin the run (assigns ``run_id`` for backends that have one).

        Called BEFORE the run folder exists — the folder is derived from
        ``run_id`` (reference nests artifacts under the MLflow run) and
        attached afterwards via :meth:`set_run_folder`.
        """

    def set_run_folder(self, save_folder: Path):
        pass

    def log_params(self, params: dict):
        pass

    def log_dict(self, d: dict, artifact_path: str):
        pass

    def log_metrics(self, metrics: dict, step: int):
        pass

    def log_artifact(self, path, artifact_path=None):
        pass

    def end_run(self):
        pass


class LocalTracker(NullTracker):
    """File-based stand-in keeping the reference's logged surface."""

    def __init__(self):
        self._folder: Optional[Path] = None
        self._params: dict = {}

    def set_run_folder(self, save_folder: Path):
        self._folder = Path(save_folder)

    def _write_params(self):
        if self._folder is not None:
            with open(self._folder / "mlflow_params.json", "w") as fh:
                json.dump(self._params, fh, indent=2, default=str)

    def log_params(self, params: dict):
        self._params.update(params)
        self._write_params()

    def log_dict(self, d: dict, artifact_path: str):
        if self._folder is None:
            return
        # Preserve the artifact SUBPATH (mirroring MLflow's layout):
        # flattening to the basename would let two artifacts with the
        # same filename under different directories overwrite each other.
        out = self._folder / artifact_path
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as fh:
            json.dump(d, fh, indent=2, default=str)

    def log_metrics(self, metrics: dict, step: int):
        if self._folder is None:
            return
        with open(self._folder / "mlflow_metrics.jsonl", "a") as fh:
            fh.write(json.dumps({"step": step, **metrics}, default=str) + "\n")

    def log_artifact(self, path, artifact_path=None):
        # Checkpoints already live in the run folder; only copy when an
        # artifact subfolder (e.g. "model") relocates them.
        if self._folder is None or artifact_path is None:
            return
        import shutil

        dest = self._folder / artifact_path
        dest.mkdir(parents=True, exist_ok=True)
        src = Path(path)
        if src.resolve().parent != dest.resolve():
            shutil.copy2(src, dest / src.name)


class MlflowTracker(NullTracker):
    def __init__(self, params: MLflowParameters):
        import mlflow

        self._mlflow = mlflow
        if params.username:
            os.environ["MLFLOW_TRACKING_USERNAME"] = params.username
        if params.password:
            os.environ["MLFLOW_TRACKING_PASSWORD"] = params.password
        mlflow.set_tracking_uri(params.tracking_uri)
        mlflow.set_experiment(params.experiment)
        self._run = None

    @property
    def run_id(self):
        return self._run.info.run_id if self._run else ""

    def start_run(self):
        self._run = self._mlflow.start_run()
        log.info(f"MLFlow Run ID: {self._run.info.run_id}")

    def log_params(self, params: dict):
        self._mlflow.log_params(params)

    def log_dict(self, d: dict, artifact_path: str):
        self._mlflow.log_dict(d, artifact_path)

    def log_metrics(self, metrics: dict, step: int):
        self._mlflow.log_metrics(metrics, step=step)

    def log_artifact(self, path, artifact_path=None):
        self._mlflow.log_artifact(str(path), artifact_path=artifact_path)

    def end_run(self):
        self._mlflow.end_run()


class TrackingConnectionError(RuntimeError):
    """MLflow tracker construction failed (auth/transport). Raised as a
    catchable library error; the CLI maps it to exit code 1 (the
    reference calls ``sys.exit(1)`` inline, `training/training.py:148-162`,
    which would kill an embedding interpreter)."""


def get_tracker(mlflow_params: Optional[MLflowParameters]):
    """Tracker factory: MLflow if requested & importable, else local files."""
    if mlflow_params is None:
        return LocalTracker()
    try:
        return MlflowTracker(mlflow_params)
    except ImportError:
        log.warning(
            "MLflowParameters provided but mlflow is not installed; "
            "falling back to local JSON tracking"
        )
        return LocalTracker()
    except Exception as exc:
        # Auth/transport failures (e.g. a wrong MLFLOW_TRACKING_PASSWORD
        # raising MlflowException from set_experiment) surface the
        # credential hint instead of a raw traceback — reference
        # `training/training.py:148-162`.
        try:
            from mlflow.exceptions import MlflowException
        except Exception:
            raise exc
        if isinstance(exc, MlflowException):
            msg = (
                f"MLflow connection failed: {exc} — check the tracking URI "
                "and MLFLOW_TRACKING_USERNAME/MLFLOW_TRACKING_PASSWORD "
                "credentials"
            )
            log.error(msg)
            raise TrackingConnectionError(msg) from exc
        raise


class TensorBoardWriter:
    """Mirrors epoch scalars to TensorBoard event files (SURVEY.md §5 —
    the reference has MLflow only; TB is additive observability)."""

    def __init__(self, log_dir: Path):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            from tensorboardX import SummaryWriter

        self._writer = SummaryWriter(log_dir=str(log_dir))

    def log_metrics(self, metrics: dict, step: int):
        for name, value in metrics.items():
            try:
                self._writer.add_scalar(name, float(value), step)
            except (TypeError, ValueError):
                continue

    def close(self):
        self._writer.flush()
        self._writer.close()


def get_tensorboard_writer(log_dir: Path) -> Optional[TensorBoardWriter]:
    """TensorBoard writer factory; returns None (with a warning) when no
    tensorboard backend is importable."""
    try:
        return TensorBoardWriter(log_dir)
    except ImportError:
        log.warning(
            "tensorboard=True but no event-file writer is importable "
            "(needs torch.utils.tensorboard or tensorboardX); skipping "
            "TensorBoard event files"
        )
        return None
