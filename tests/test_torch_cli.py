"""The port's CLI (``python -m oct_image_segmentation_models_torch.cli``)
against the JAX package's ``cli.py``.

- The parsers have the same subcommands, arguments, defaults and choices;
  the port adds ``--device`` to each and targets ``cpu,cuda`` where JAX
  targets ``cpu,tpu``.
- One ``config.json`` gives both packages' ``train`` the same
  ``TrainingParams`` fields; unknown keys are refused and ``--output-dir``
  beats ``results_location`` in both.
- ``predict``, ``evaluate`` and ``export-keras`` write the JAX CLI's
  artifact trees from the same checkpoint and HDF5 file (compared as
  ``tests/test_torch_predict_evaluate.py`` compares them), as does
  ``evaluation-scripts/evaluate_model_torch.py``.
- A one-epoch ``train`` runs through the CLI, and an MLflow connection
  failure exits with code 1.
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import fake_mlflow
from oct_image_segmentation_models_tpu import cli as jax_cli
from oct_image_segmentation_models_tpu.common.model_io import save_model as jax_save_model
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_torch import cli

from synth import make_dataset
from test_torch_predict_evaluate import _assert_hdf5_equal, _assert_trees_equal
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

REPO = Path(__file__).resolve().parents[1]
H, W, C = 32, 48, 4
SUBCOMMANDS = ["train", "predict", "evaluate", "export", "export-keras"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(JAX-written checkpoint, dataset) shared by the module."""
    root = tmp_path_factory.mktemp("torch_cli")
    container = jax_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=2, pool_layers=2,
    )
    module = container.build_model()
    variables = jax.jit(
        lambda key: module.init(key, np.zeros((1, H, W, 1), np.float32), training=False)
    )(jax.random.PRNGKey(7))
    model_path = root / "model.hdf5"
    jax_save_model(
        model_path, "unet", container.get_config(),
        jax.tree_util.tree_map(np.asarray, dict(variables)),
    )
    ds = make_dataset(root / "ds.hdf5", n_train=4, n_val=2, n_test=2, h=H, w=W,
                      num_classes=C, seed=2)
    return model_path, ds


def _subparsers(parser):
    (action,) = [a for a in parser._actions if a.dest == "command"]
    return action.choices


def _arguments(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.required,
                 type(a).__name__)
        for a in parser._actions
        if a.dest != "help"
    }


def test_parser_matches_jax():
    port, jax_subs = _subparsers(cli.build_parser()), _subparsers(jax_cli.build_parser())
    assert list(port) == list(jax_subs) == SUBCOMMANDS
    for name in SUBCOMMANDS:
        got, want = _arguments(port[name]), _arguments(jax_subs[name])
        device = got.pop("device")
        assert device[:2] == (("--device",), None)
        if name == "export":
            assert got.pop("platforms")[1] == "cpu,cuda"
            assert want.pop("platforms")[1] == "cpu,tpu"
        assert got == want, name
        assert port[name].get_default("func").__name__ == (
            jax_subs[name].get_default("func").__name__
        )
    args = cli.build_parser().parse_args(["predict", "m", "d", "o", "--num-workers", "3"])
    assert (args.num_workers, args.batch_size, args.minpath_tie_parity) == (3, 8, "fast")
    assert args.device is None
    args = cli.build_parser().parse_args(["evaluate", "m", "d", "o", "--device", "cpu"])
    assert (args.num_workers, args.device, args.no_graph_search) == ("auto", "cpu", False)


def _captured_params(monkeypatch, config_path, argv):
    """The TrainingParams that each package's ``train`` subcommand builds
    from ``config_path`` and ``argv`` -> (port's on the CPU, JAX's);
    nothing trains."""
    import oct_image_segmentation_models_torch.training as port_training
    import oct_image_segmentation_models_tpu.training as jax_training

    seen = {}
    monkeypatch.setattr(port_training, "train_model", lambda p, m: seen.setdefault("port", p))
    monkeypatch.setattr(jax_training, "train_model", lambda p, m: seen.setdefault("jax", p))
    cli.main(["train", str(config_path), "--device", "cpu", *argv])
    jax_cli.main(["train", str(config_path), *argv])
    return seen["port"], seen["jax"]


def _by_name(value):
    """``value`` with each function replaced by its name (the two packages'
    augmentation functions are their own)."""
    if callable(value):
        return value.__name__
    if isinstance(value, dict):
        return {k: _by_name(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_by_name(v) for v in value)
    return value


def test_train_config_maps_to_the_same_params(tmp_path, monkeypatch, capsys):
    config = {
        "model_architecture": "unet", "training_dataset_path": "ds.hdf5",
        "results_location": str(tmp_path / "runs"), "optimizer": "sgd",
        "opt_params": {"learning_rate": 0.01}, "loss": "focal_dice_loss",
        "metric": "dice_coef_micro", "epochs": 3, "batch_size": 4,
        "model_hyperparameters": {"start_neurons": 2}, "loss_fn_kwargs": {"gamma": 1.5},
        "augmentations": [{"name": "flip", "arguments": {"flip_type": "left-right"}}],
        "aug_mode": "one", "aug_probs": [0.5], "aug_fly": True, "aug_val": False,
        "shuffle": False, "model_save_best": False, "class_weight": "balanced",
        "early_stopping": False, "restore_best_weights": False, "patience": 7,
        "seed": 3, "model_save_monitor": ["val_loss", "min"], "channels_last": True,
        "profile_dir": str(tmp_path / "prof"), "train_step_impl": "auto",
        "train_forward_impl": "parity", "aug_device": "off", "checkpoint_format": "orbax",
        "tensorboard": True, "train_state_checkpoint": True,
        "resume_config_check": "warn", "bn_precise_stats": False, "bn_precise_val": False,
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    for argv, results in (
        ([], tmp_path / "runs"),
        (["--output-dir", str(tmp_path / "override")], tmp_path / "override"),
    ):
        port, jax_params = _captured_params(monkeypatch, path, argv)
        got, want = _by_name(vars(port)), _by_name(vars(jax_params))
        assert got.pop("device") == "cpu"
        assert got == want
        assert port.results_location == results

    bad = dict(config, epoch=3)  # a typo of "epochs"
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit, match="unknown config key"):
            main(["train", str(tmp_path / "bad.json")])


def test_cli_train_one_epoch(inputs, tmp_path):
    _, ds = inputs
    config = {
        "model_architecture": "unet", "training_dataset_path": str(ds),
        "results_location": str(tmp_path / "runs"), "optimizer": "adam",
        "loss": "dice_loss_macro", "metric": "dice_coef_macro", "epochs": 1,
        "batch_size": 2, "model_hyperparameters": {"start_neurons": 2, "pool_layers": 2},
        "seed": 0, "model_save_monitor": ["val_loss", "min"],
        "train_forward_impl": "parity", "aug_device": "off",
    }
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    cli.main(["train", str(cfg_path), "--device", "cpu"])
    assert list((tmp_path / "runs").glob("*/model_final.hdf5"))


@pytest.mark.parametrize("command", ["predict", "evaluate"])
def test_predict_and_evaluate_trees_match_jax(inputs, tmp_path, command):
    model_path, ds = inputs
    flags = ["--batch-size", "2", "--num-workers", "0", "--minpath-tie-parity", "exact"]
    if command == "predict":
        flags.append("--graph-search")
    jax_cli.main([command, str(model_path), str(ds), str(tmp_path / "jax"), *flags])
    cli.main([command, str(model_path), str(ds), str(tmp_path / "torch"), *flags,
              "--device", "cpu"])
    _assert_trees_equal(tmp_path / "torch", tmp_path / "jax")
    if command == "evaluate":
        # the evaluation script beside JAX's, on the port's CLI
        argv = sys.argv
        sys.argv = [
            "evaluate_model_torch.py", str(model_path), str(ds), str(tmp_path / "script"),
            *flags, "--device", "cpu",
        ]
        try:
            with pytest.raises(SystemExit) as done:
                runpy.run_path(
                    str(REPO / "evaluation-scripts" / "evaluate_model_torch.py"),
                    run_name="__main__",
                )
        finally:
            sys.argv = argv
        assert not done.value.code
        _assert_trees_equal(tmp_path / "script", tmp_path / "jax")


def test_export_keras_matches_jax(inputs, tmp_path, capsys):
    model_path, _ = inputs
    for main, side in ((cli.main, "torch"), (jax_cli.main, "jax")):
        (tmp_path / side).mkdir()
        argv = ["export-keras", str(model_path), str(tmp_path / side / "keras.h5")]
        main(argv + (["--device", "cpu"] if side == "torch" else []))
    assert "Exported Keras weights checkpoint" in capsys.readouterr().out
    _assert_hdf5_equal(tmp_path / "torch" / "keras.h5", tmp_path / "jax" / "keras.h5")
    assert (tmp_path / "torch" / "model_config.json").read_bytes() == (
        tmp_path / "jax" / "model_config.json"
    ).read_bytes()
    cli.main(["export-keras", str(model_path), str(tmp_path / "bare.h5"), "--no-sidecar",
              "--device", "cpu"])
    assert not (tmp_path / "model_config.json").exists()


def test_tracking_connection_error_exits_1(inputs, tmp_path, monkeypatch, capsys):
    _, ds = inputs
    monkeypatch.setitem(sys.modules, "mlflow", fake_mlflow)
    monkeypatch.setitem(sys.modules, "mlflow.exceptions", fake_mlflow.exceptions)

    def boom(name):
        raise fake_mlflow.MlflowException("API request failed: 401")

    monkeypatch.setattr(fake_mlflow, "set_experiment", boom)
    config = {
        "model_architecture": "unet", "training_dataset_path": str(ds), "epochs": 1,
        "mlflow": {"tracking_uri": str(tmp_path / "mlruns"), "experiment": "e"},
    }
    (tmp_path / "config.json").write_text(json.dumps(config))
    assert cli.main(["train", str(tmp_path / "config.json"), "--device", "cpu"]) == 1
    assert "MLflow connection failed" in capsys.readouterr().err
    assert not (tmp_path / "runs").exists()
