"""Command-line interface of the PyTorch port, counterpart of the JAX
package's ``cli.py``:

    python -m oct_image_segmentation_models_torch.cli {train,predict,evaluate,export,export-keras} ...

The subcommands, arguments, defaults and help are the JAX package's, and
the ``train`` config file takes its keys, so one ``config.json`` serves
both packages. Every subcommand adds ``--device`` (default: the CUDA
card; pass ``cpu`` to run on the CPU), where the JAX package picks its
platform by environment variable.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _load_config(path):
    with open(path) as fh:
        return json.load(fh)


# Keys cmd_train takes from config.json: anything else is a typo ("epoch"
# for "epochs", "optimiser" for "optimizer") that would otherwise train a
# long run with defaults.
_TRAIN_CONFIG_KEYS = frozenset(
    {
        "mlflow",
        "model_architecture",
        "training_dataset_path",
        "initial_model",
        "results_location",
        "optimizer",
        "opt_params",
        "loss",
        "metric",
        "epochs",
        "batch_size",
        "model_hyperparameters",
        "loss_fn_kwargs",
        "augmentations",
        "aug_mode",
        "aug_probs",
        "aug_fly",
        "aug_val",
        "shuffle",
        "model_save_best",
        "class_weight",
        "early_stopping",
        "restore_best_weights",
        "patience",
        "seed",
        "model_save_monitor",
        "channels_last",
        "profile_dir",
        "train_step_impl",
        "train_forward_impl",
        "aug_device",
        "checkpoint_format",
        "tensorboard",
        "train_state_checkpoint",
        "resume_train_state",
        "resume_config_check",
        "bn_precise_stats",
        "bn_precise_val",
    }
)


def cmd_train(args):
    from .common.mlflow_parameters import MLflowParameters
    from .training import TrainingParams, train_model

    config = _load_config(args.config)
    unknown = sorted(set(config) - _TRAIN_CONFIG_KEYS)
    if unknown:
        raise SystemExit(
            f"octseg train: unknown config key(s) {unknown} — "
            "misspelled keys would otherwise silently fall back to "
            f"defaults (known keys: {sorted(_TRAIN_CONFIG_KEYS)})"
        )
    mlflow_cfg = config.pop("mlflow", None)
    mlflow_params = MLflowParameters(**mlflow_cfg) if mlflow_cfg else None
    # An explicit --output-dir wins over the config file's results_location.
    if args.output_dir is not None:
        config["results_location"] = args.output_dir
    else:
        config.setdefault("results_location", ".")
    params = TrainingParams(
        model_architecture=config.get("model_architecture"),
        training_dataset_path=Path(config["training_dataset_path"]),
        initial_model=(
            Path(config["initial_model"]) if config.get("initial_model") else None
        ),
        results_location=Path(config["results_location"]),
        opt_con=config.get("optimizer", "adam"),
        opt_params=config.get("opt_params", {}),
        loss=config.get("loss", "dice_loss_macro"),
        metric=config.get("metric", "dice_coef_macro"),
        epochs=config.get("epochs", 50),
        batch_size=config.get("batch_size", 8),
        model_hyperparameters=config.get("model_hyperparameters", {}),
        loss_fn_kwargs=config.get("loss_fn_kwargs", {}),
        augmentations=config.get("augmentations", []),
        aug_mode=config.get("aug_mode", "none"),
        aug_probs=tuple(config.get("aug_probs", ())),
        aug_fly=config.get("aug_fly", False),
        aug_val=config.get("aug_val", True),
        shuffle=config.get("shuffle", True),
        model_save_best=config.get("model_save_best", True),
        class_weight=config.get("class_weight"),
        early_stopping=config.get("early_stopping", True),
        restore_best_weights=config.get("restore_best_weights", True),
        patience=config.get("patience", 50),
        seed=config.get("seed"),
        model_save_monitor=tuple(config.get("model_save_monitor", ("val_acc", "max"))),
        channels_last=config.get("channels_last", True),
        profile_dir=(Path(config["profile_dir"]) if config.get("profile_dir") else None),
        train_step_impl=config.get("train_step_impl", "auto"),
        train_forward_impl=config.get("train_forward_impl", "auto"),
        aug_device=config.get("aug_device", "auto"),
        checkpoint_format=config.get("checkpoint_format", "hdf5"),
        tensorboard=config.get("tensorboard", False),
        train_state_checkpoint=config.get("train_state_checkpoint", False),
        resume_train_state=config.get("resume_train_state"),
        resume_config_check=config.get("resume_config_check", "strict"),
        bn_precise_stats=config.get("bn_precise_stats", True),
        bn_precise_val=config.get("bn_precise_val", True),
        device=args.device,
    )
    folder = train_model(params, mlflow_params)
    print(f"Training complete. Artifacts: {folder}")


def cmd_predict(args):
    import h5py
    import numpy as np

    from .common.dataset import Dataset
    from .common.dataset_loader import load_prediction_images
    from .prediction import PredictionParams, PredictionSaveParams, predict

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with h5py.File(args.dataset, "r") as f:
        images, names = load_prediction_images(f)
    out_dirs = [output_dir / f"image_{i}" for i in range(len(images))]
    params = PredictionParams(
        model_path=Path(args.model),
        mlflow_tracking_uri=args.mlflow_tracking_uri,
        mlflow_run_uuid=args.mlflow_run_uuid,
        dataset=Dataset(np.asarray(images), None, names, out_dirs),
        config_output_dir=output_dir,
        save_params=PredictionSaveParams(),
        graph_search=args.graph_search,
        batch_size=args.batch_size,
        minpath_tie_parity=args.minpath_tie_parity,
        compute_dtype=args.compute_dtype,
        num_workers=args.num_workers,
        device=args.device,
    )
    predict(params)
    print(f"Prediction complete. Artifacts: {output_dir}")


def cmd_evaluate(args):
    from .evaluation import EvaluationParameters, EvaluationSaveParams, evaluate_model

    params = EvaluationParameters(
        model_path=Path(args.model),
        mlflow_tracking_uri=args.mlflow_tracking_uri,
        mlflow_run_uuid=args.mlflow_run_uuid,
        test_dataset_path=Path(args.dataset),
        save_foldername=Path(args.output_dir),
        save_params=EvaluationSaveParams(),
        graph_search=not args.no_graph_search,
        metrics=args.metrics.split(","),
        gsgrad=args.gsgrad,
        batch_size=args.batch_size,
        minpath_tie_parity=args.minpath_tie_parity,
        compute_dtype=args.compute_dtype,
        num_workers=args.num_workers,
        device=args.device,
    )
    evaluate_model(params)
    print(f"Evaluation complete. Artifacts: {args.output_dir}")


def cmd_export(args):
    from .common.export import export_inference_pipeline

    out = export_inference_pipeline(
        Path(args.model),
        Path(args.output),
        image_height=args.height,
        image_width=args.width,
        batch_size=None if args.dynamic_batch else args.batch_size,
        with_graph_search=not args.no_graph_search,
        return_maps=not args.no_maps,
        minpath_tie_parity=args.minpath_tie_parity,
        optimize=not args.no_optimize,
        compute_dtype=args.compute_dtype,
        platforms=tuple(args.platforms.split(",")),
        mlflow_tracking_uri=args.mlflow_tracking_uri,
        mlflow_run_uuid=args.mlflow_run_uuid,
        device=args.device,
    )
    print(f"Exported torch.export inference artifact: {out}")


def cmd_export_keras(args):
    from .common.model_io import load_model_and_config, save_keras_weights

    loaded, model_config = load_model_and_config(
        Path(args.model),
        mlflow_tracking_uri=args.mlflow_tracking_uri,
        mlflow_run_uuid=args.mlflow_run_uuid,
        device=args.device,
    )
    out = save_keras_weights(
        Path(args.output),
        loaded.name,
        model_config,
        loaded.module.state_dict(),
        write_sidecar=not args.no_sidecar,
    )
    print(f"Exported Keras weights checkpoint: {out}")


def _add_device(parser, what: str = "runs"):
    parser.add_argument(
        "--device",
        default=None,
        help=f"torch device the command {what} on (default: the CUDA card; "
        "'cpu' runs on the CPU)",
    )


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m oct_image_segmentation_models_torch.cli",
        description="OCT image segmentation, PyTorch port",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model from a config.json")
    p_train.add_argument("config")
    p_train.add_argument("--output-dir", default=None)
    _add_device(p_train, "trains")
    p_train.set_defaults(func=cmd_train)

    p_pred = sub.add_parser("predict", help="predict on an HDF5 image set")
    p_pred.add_argument("model")
    p_pred.add_argument("dataset")
    p_pred.add_argument("output_dir")
    p_pred.add_argument("--graph-search", action="store_true")
    p_pred.add_argument("--batch-size", type=int, default=8)
    p_pred.add_argument(
        "--minpath-tie-parity",
        choices=("exact", "fast"),
        default="fast",
        help="min-path tie-break mode: 'fast' (default) is cost-optimal; "
        "'exact' bit-matches the reference heap (migration validation)",
    )
    p_pred.add_argument(
        "--compute-dtype",
        choices=("float32", "bfloat16"),
        default="float32",
        help="conv-stack dtype on the optimized fast paths",
    )
    p_pred.add_argument(
        "--num-workers",
        type=lambda v: v if v == "auto" else int(v),
        default="auto",
        help="worker processes for per-image artifact writing "
        "(HDF5/CSV/PNG); 0 = serial, auto = min(4, cpus-1)",
    )
    p_pred.add_argument("--mlflow-tracking-uri", default=None)
    p_pred.add_argument("--mlflow-run-uuid", default=None)
    _add_device(p_pred)
    p_pred.set_defaults(func=cmd_predict)

    p_eval = sub.add_parser("evaluate", help="evaluate a model on a test HDF5 dataset")
    p_eval.add_argument("model")
    p_eval.add_argument("dataset")
    p_eval.add_argument("output_dir")
    p_eval.add_argument("--no-graph-search", action="store_true")
    p_eval.add_argument(
        "--metrics",
        default="dice_coef_classes,dice_coef_macro,dice_coef_micro",
    )
    p_eval.add_argument("--gsgrad", type=int, default=1)
    p_eval.add_argument("--batch-size", type=int, default=8)
    p_eval.add_argument(
        "--minpath-tie-parity",
        choices=("exact", "fast"),
        default="fast",
        help="min-path tie-break mode (see the predict subcommand's --help)",
    )
    p_eval.add_argument(
        "--compute-dtype",
        choices=("float32", "bfloat16"),
        default="float32",
        help="conv-stack dtype on the optimized fast paths",
    )
    p_eval.add_argument(
        "--num-workers",
        type=lambda v: v if v == "auto" else int(v),
        default="auto",
        help="worker processes for the per-image metrics/artifact phase; "
        "0 = serial, auto = min(4, cpus-1)",
    )
    p_eval.add_argument("--mlflow-tracking-uri", default=None)
    p_eval.add_argument("--mlflow-run-uuid", default=None)
    _add_device(p_eval)
    p_eval.set_defaults(func=cmd_evaluate)

    p_exp = sub.add_parser(
        "export",
        help="export a trained model's fused inference pipeline to a "
        "self-contained torch.export deployment artifact",
    )
    p_exp.add_argument("model")
    p_exp.add_argument("output")
    p_exp.add_argument("--height", type=int, default=None)
    p_exp.add_argument("--width", type=int, default=None)
    p_exp.add_argument("--batch-size", type=int, default=8)
    p_exp.add_argument(
        "--dynamic-batch",
        action="store_true",
        help="export with a symbolic batch dimension: one artifact "
        "serves any batch size",
    )
    p_exp.add_argument("--no-graph-search", action="store_true")
    p_exp.add_argument("--no-maps", action="store_true")
    p_exp.add_argument("--no-optimize", action="store_true")
    p_exp.add_argument("--minpath-tie-parity", choices=("exact", "fast"), default="fast")
    p_exp.add_argument(
        "--compute-dtype",
        choices=("float32", "bfloat16"),
        default="float32",
        help="conv-stack dtype on the optimized fast paths",
    )
    p_exp.add_argument(
        "--platforms",
        default="cpu,cuda",
        help="comma-separated torch device types the artifact targets "
        "(each program is traced on its device; 'cuda' needs the card)",
    )
    p_exp.add_argument("--mlflow-tracking-uri", default=None)
    p_exp.add_argument("--mlflow-run-uuid", default=None)
    _add_device(p_exp, "loads the model")
    p_exp.set_defaults(func=cmd_export)

    p_keras = sub.add_parser(
        "export-keras",
        help="export a trained model's weights to a reference-consumable "
        "Keras HDF5 (rebuild there with the reference's build_model() "
        "and model.load_weights())",
    )
    p_keras.add_argument("model")
    p_keras.add_argument("output")
    p_keras.add_argument(
        "--no-sidecar",
        action="store_true",
        help="skip writing model_config.json next to the output",
    )
    p_keras.add_argument("--mlflow-tracking-uri", default=None)
    p_keras.add_argument("--mlflow-run-uuid", default=None)
    _add_device(p_keras, "loads the model")
    p_keras.set_defaults(func=cmd_export_keras)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    from .common.tracking import TrackingConnectionError

    try:
        return args.func(args)
    except TrackingConnectionError as exc:
        # Library code raises a catchable error; the exit code is decided
        # here.
        print(f"octseg: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
