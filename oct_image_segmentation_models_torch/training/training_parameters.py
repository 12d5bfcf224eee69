"""Training configuration, counterpart of the JAX package's
``training/training_parameters.py``: the same parameter surface and
validation (invalid configuration raises ``ValueError``), plus ``device``
(None means CUDA, and raises without a card; pass ``"cpu"`` to train on
the CPU).

``opt_con`` is an optimizer name ("Adam", "sgd", ...) or a callable that
returns a ``torch.optim.Optimizer`` factory (see
``parallel.train_step.build_optimizer``). ``train_forward_impl`` "auto"
and "parity" both train the plain module; "s2d" (the JAX package's
space-to-depth training forward for the TPU) is not ported and raises at
training time. ``checkpoint_format="orbax"`` writes the port's directory
checkpoints (``common.model_io.save_model_dir``) under the JAX package's
``.orbax`` names.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

from ..common import AUG_MODES
from ..common import augmentation as aug


class TrainingParams:
    def __init__(
        self,
        model_architecture: Union[str, None],
        training_dataset_path: Path,
        initial_model: Union[Path, None],
        results_location: Path,
        opt_con,
        loss: str,
        metric: str,
        epochs: int,
        batch_size: int,
        model_hyperparameters: dict = None,
        opt_params: dict = None,
        loss_fn_kwargs: dict = None,
        augmentations: List[dict] = None,
        aug_mode: str = "none",
        aug_probs: Tuple = (),
        aug_fly: bool = False,
        aug_val: bool = True,
        shuffle: bool = True,
        model_save_best: bool = True,
        model_save_monitor=("val_acc", "max"),
        class_weight: Union[list, str, None] = None,
        channels_last: bool = True,
        early_stopping: bool = True,
        restore_best_weights: bool = True,
        patience: int = 50,
        seed: Optional[int] = None,
        profile_dir: Optional[Path] = None,
        train_step_impl: str = "auto",
        train_forward_impl: str = "auto",
        aug_device: str = "auto",
        checkpoint_format: str = "hdf5",
        tensorboard: bool = False,
        train_state_checkpoint: bool = False,
        resume_train_state: Union[Path, str, None] = None,
        resume_config_check: str = "strict",
        bn_precise_stats: bool = True,
        bn_precise_val: bool = True,
        device=None,
    ):
        n_sources = sum(
            x is not None
            for x in (model_architecture, initial_model, resume_train_state)
        )
        if n_sources != 1:
            raise ValueError(
                "Exactly one of 'model_architecture', 'initial_model', or "
                "'resume_train_state' needs to be provided."
            )

        self.model_architecture = model_architecture
        self.model_hyperparameters = model_hyperparameters or {}
        self.training_dataset_path = Path(training_dataset_path)
        self.initial_model = Path(initial_model) if initial_model else None
        self.results_location = Path(results_location)
        self.opt_con = opt_con
        self.opt_params = opt_params or {}
        self.loss = loss
        self.loss_fn_kwargs = loss_fn_kwargs or {}
        self.metric = metric
        self.epochs = epochs
        self.batch_size = batch_size

        if aug_mode not in AUG_MODES:
            raise ValueError(f"Augmentation mode: '{aug_mode}' is not supported.")
        self.aug_mode = aug_mode

        self.aug_fn_args = []
        for augmentation in augmentations or []:
            aug_fn = aug.augmentation_map.get(augmentation["name"])
            if aug_fn is None:
                raise ValueError(
                    f"Augmentation: '{augmentation['name']}' is not supported."
                )
            self.aug_fn_args.append((aug_fn, augmentation.get("arguments", {})))
        self.augmentations = augmentations or []

        self.aug_probs = aug_probs
        self.aug_fly = aug_fly
        self.aug_val = aug_val
        self.shuffle = shuffle
        self.model_save_best = model_save_best
        self.model_save_monitor = model_save_monitor
        self.class_weight = class_weight
        self.channels_last = channels_last
        self.early_stopping = early_stopping
        self.restore_best_weights = restore_best_weights
        self.patience = patience
        self.seed = seed
        # Optional torch.profiler trace of the first training epoch.
        self.profile_dir = Path(profile_dir) if profile_dir else None
        # Step implementation: "auto" | "spmd" (one device); "shard_map"
        # is data parallelism (see parallel/train_step.py).
        self.train_step_impl = train_step_impl
        if train_forward_impl not in ("auto", "s2d", "parity"):
            raise ValueError(
                f"unknown train_forward_impl: {train_forward_impl}"
            )
        self.train_forward_impl = train_forward_impl
        if aug_device not in ("auto", "on", "off") and not isinstance(
            aug_device, bool
        ):
            raise ValueError(f"unknown aug_device: {aug_device}")
        if isinstance(aug_device, bool):
            aug_device = "on" if aug_device else "off"
        self.aug_device = aug_device
        # Checkpoint backend: "hdf5" (reference-parity single files);
        # "orbax" is accepted here as in the JAX package and refused by
        # train_model.
        if checkpoint_format not in ("hdf5", "orbax"):
            raise ValueError(
                f"checkpoint_format must be 'hdf5' or 'orbax', "
                f"got {checkpoint_format!r}"
            )
        self.checkpoint_format = checkpoint_format
        # Also mirror epoch scalars to TensorBoard event files under
        # <run>/tensorboard (in addition to the MLflow/local tracker).
        self.tensorboard = tensorboard
        # Preemption-safe training: a rolling full-train-state checkpoint
        # (params + optimizer state + RNG + epoch + best-monitor state)
        # after every epoch, plus a SIGTERM/SIGINT handler that finishes
        # the current batch, writes final artifacts, and exits cleanly.
        # ``resume_train_state`` continues BITWISE-identically to the
        # uninterrupted run (see training.py::save_train_state).
        self.train_state_checkpoint = bool(train_state_checkpoint)
        self.resume_train_state = (
            Path(resume_train_state) if resume_train_state else None
        )
        # Run-config mismatch handling on resume: "strict" raises (the
        # default — a changed hyperparameter silently voids the
        # bitwise-identical-resume guarantee), "warn" logs and
        # continues. The escape hatch exists for false rejections the
        # structural callable projection can't see through, e.g. a
        # library upgrade that reshapes the internal closures of a
        # callable passed as ``opt_con``.
        if resume_config_check not in ("strict", "warn"):
            raise ValueError(
                "resume_config_check must be 'strict' or 'warn', "
                f"got {resume_config_check!r}"
            )
        self.resume_config_check = resume_config_check
        # Finalize the saved checkpoint's BatchNorm statistics as exact
        # population statistics of the training data under the final
        # weights ("precise BN", ops/bn_refresh.py) instead of the
        # Keras-style momentum-0.99 rolling average — the rolling stats
        # lag the trained weights (init residual 0.99^steps) and degrade
        # eval-mode accuracy. False restores reference-exact
        # finalization.
        self.bn_precise_stats = bool(bn_precise_stats)
        # Compute each epoch's val_loss / val_<metric> — the signal that
        # drives best-checkpoint selection (model_save_monitor) AND early
        # stopping — with precise-BN statistics refreshed under the
        # epoch's weights (one extra forward pass over the training set
        # per epoch) instead of the rolling statistics, which misread
        # checkpoint quality exactly where statistics matter. False restores Keras-exact epoch-metric semantics (and the
        # extra pass's cost). Saved checkpoints are governed separately
        # by bn_precise_stats.
        self.bn_precise_val = bool(bn_precise_val)
        self.device = device

        # "val_acc" default is rewritten to the configured metric
        # (reference `training_parameters.py:131-136`).
        if self.model_save_monitor[0] == "val_acc":
            self.model_save_monitor = [
                "val_" + self.metric,
                model_save_monitor[1],
            ]
