"""The port's directory checkpoints and MLflow loading
(``common/model_io.py``), against the JAX package where both read the
same thing.

- The directory checkpoint (the port's counterpart of JAX's Orbax
  backend) round-trips a U-Net and a DeepLabV3+ with h5py blocked.
- ``train_model(checkpoint_format="orbax")`` writes ``.orbax`` directories
  under JAX's names, with the weights an HDF5 run of the same seed writes,
  and a run resumes from ``model_final.orbax`` (JAX's
  ``test_orbax_checkpoint_and_tensorboard``).
- A directory that JAX's Orbax backend wrote raises the conversion error.
- MLflow runs through ``tests/fake_mlflow.py``: the port's run loads by run
  id and by artifact URI, the run's logged config wins over the embedded
  one, and an absolute path with a run id is refused, as JAX's
  ``load_model_and_config`` does on the same store.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import fake_mlflow
from oct_image_segmentation_models_tpu.common import model_io as jax_model_io
from oct_image_segmentation_models_torch.common import model_io
from oct_image_segmentation_models_torch.common.mlflow_parameters import MLflowParameters
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.training import TrainingParams, train_model

from synth import make_dataset
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

H, W = 32, 48


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("torch_checkpoints") / "ds.hdf5")


def _params(dataset, results, **kw):
    defaults = dict(
        model_architecture="unet", training_dataset_path=dataset, initial_model=None,
        results_location=results, opt_con="adam", opt_params={"learning_rate": 1e-3},
        loss="dice_loss_macro", metric="dice_coef_macro", epochs=2, batch_size=2,
        model_hyperparameters={"start_neurons": 2, "pool_layers": 2}, seed=5,
        device="cpu",
    )
    return TrainingParams(**{**defaults, **kw})


def _state(path):
    return model_io.load_checkpoint(path)[2]


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


@pytest.mark.parametrize(
    "name,extra",
    [("unet", {"start_neurons": 2, "pool_layers": 2}), ("deeplabv3plus", {})],
)
def test_directory_round_trip_without_h5py(tmp_path, monkeypatch, name, extra):
    channels = 3 if name == "deeplabv3plus" else 1
    container = get_model_class(name)(
        input_channels=channels, num_classes=3, image_height=32, image_width=32, **extra
    )
    module = container.build_model(generator=torch.Generator().manual_seed(1), device="cpu")
    path = tmp_path / "model.orbax"
    monkeypatch.setitem(sys.modules, "h5py", None)
    model_io.save_model_dir(path, name, container.get_config(), module.state_dict())
    assert sorted(p.name for p in path.iterdir()) == ["octseg_model.json", "state_dict.pt"]
    want_config = json.loads(json.dumps(container.get_config()))
    assert json.loads((path / "octseg_model.json").read_text()) == {
        "model_name": name, "model_config": want_config,
    }
    loaded, config = model_io.load_model_and_config(path, device="cpu")
    assert loaded.name == name and config == want_config
    _assert_state_equal(loaded.module.state_dict(), module.state_dict())
    got_name, got_config, state = model_io.load_checkpoint(path)
    assert (got_name, got_config) == (name, config)
    _assert_state_equal(state, module.state_dict())
    # a model_config.json beside the checkpoint wins, as for a file
    sidecar = dict(config, image_height=64)
    (tmp_path / "model_config.json").write_text(json.dumps(sidecar))
    assert model_io.load_model_and_config(path, device="cpu")[1] == sidecar
    with pytest.raises(ValueError, match="not a directory checkpoint"):
        model_io.load_model_and_config(tmp_path, device="cpu")


def test_train_model_orbax_checkpoints_and_resume(dataset, tmp_path):
    folder = train_model(
        _params(dataset, tmp_path / "orbax", epochs=1, checkpoint_format="orbax",
                tensorboard=True)
    )
    final = folder / "model_final.orbax"
    assert final.is_dir()
    assert sorted(p.name for p in folder.glob("*.orbax"))[-1] == "model_final.orbax"
    assert not list(folder.glob("model_*.hdf5"))
    loaded, config = model_io.load_model_and_config(final, device="cpu")
    assert loaded.name == "unet"
    with torch.inference_mode():
        probs = loaded.module(torch.zeros((1, H, W, 1)))
    assert probs.shape == (1, H, W, config["num_classes"])
    assert torch.allclose(probs.sum(-1), torch.ones(()), atol=1e-5)
    events = list((folder / "tensorboard").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0

    # the same run in HDF5 checkpoints holds the same weights
    hdf5 = train_model(_params(dataset, tmp_path / "hdf5", epochs=1))
    _assert_state_equal(_state(final), _state(hdf5 / "model_final.hdf5"))
    for best in folder.glob("model_epoch*.orbax"):
        _assert_state_equal(_state(best), _state(hdf5 / f"{best.stem}.hdf5"))

    resumed = train_model(
        _params(dataset, tmp_path / "resume", epochs=1, model_architecture=None,
                initial_model=final)
    )
    assert (resumed / "model_final.hdf5").exists()


def test_jax_orbax_directory_raises_the_conversion_error(tmp_path):
    container = get_model_class("unet")(
        input_channels=1, num_classes=3, image_height=32, image_width=32,
        start_neurons=2, pool_layers=2,
    )
    module = container.build_model(generator=torch.Generator().manual_seed(2), device="cpu")
    variables = model_io.flax_from_state_dict(module.state_dict())
    path = tmp_path / "jax_model.orbax"
    jax_model_io.save_model_orbax(path, "unet", container.get_config(), variables)
    for load in (
        lambda: model_io.load_model_and_config(path, device="cpu"),
        lambda: model_io.load_checkpoint(path),
    ):
        with pytest.raises(ValueError, match="Orbax checkpoint of the JAX package"):
            load()
    # the conversion the message names gives a file both packages read
    name, config, jax_vars, _ = jax_model_io.load_model_orbax(path)
    jax_model_io.save_model(tmp_path / "converted.hdf5", name, config, jax_vars)
    loaded, _ = model_io.load_model_and_config(tmp_path / "converted.hdf5", device="cpu")
    _assert_state_equal(loaded.module.state_dict(), module.state_dict())


@pytest.fixture
def mlflow_run(dataset, tmp_path, monkeypatch):
    """(store, run id) of a port run tracked by the file-store stand-in."""
    monkeypatch.setitem(sys.modules, "mlflow", fake_mlflow)
    store = tmp_path / "mlruns"
    store.mkdir()
    folder = train_model(
        _params(dataset, tmp_path, epochs=1),
        MLflowParameters(tracking_uri=str(store), experiment="exp-port"),
    )
    run_id = folder.parent.name
    run_dir = store / "exp-port" / run_id / "artifacts"
    assert (run_dir / "model" / "model_final.hdf5").exists()
    assert (run_dir / "model" / "data" / "model_config.json").exists()
    return store, run_id


def _both(path, **kwargs):
    """The port's and JAX's loads -> ((state_dict, config), (JAX's variables
    as a port state_dict, config))."""
    loaded, config = model_io.load_model_and_config(path, device="cpu", **kwargs)
    jax_loaded, jax_config = jax_model_io.load_model_and_config(path, **kwargs)
    jax_state = model_io.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_loaded.variables)
    )
    return (loaded.module.state_dict(), config), (jax_state, jax_config)


def test_mlflow_loads_by_run_id_and_uri(mlflow_run):
    store, run_id = mlflow_run
    for path, kwargs in (
        ("model/model_final.hdf5", {"mlflow_run_uuid": run_id}),
        (f"runs:/{run_id}/model/model_final.hdf5", {}),
    ):
        (state, config), (jax_state, jax_config) = _both(
            path, mlflow_tracking_uri=str(store), **kwargs
        )
        assert config == jax_config and config["num_classes"] == 3
        _assert_state_equal(state, jax_state)


def test_mlflow_run_config_takes_precedence(mlflow_run):
    store, run_id = mlflow_run
    logged = store / "exp-port" / run_id / "artifacts" / "model" / "data" / "model_config.json"
    config = json.loads(logged.read_text())
    config["image_height"] = 2 * config["image_height"]
    logged.write_text(json.dumps(config))
    (_, got), (_, want) = _both(
        "model/model_final.hdf5", mlflow_tracking_uri=str(store), mlflow_run_uuid=run_id
    )
    assert got == want == config
    logged.unlink()  # without the artifact the embedded config stands
    (_, got), (_, want) = _both(
        "model/model_final.hdf5", mlflow_tracking_uri=str(store), mlflow_run_uuid=run_id
    )
    assert got == want and got["image_height"] == H


def test_mlflow_run_load_rejects_absolute_model_path(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "mlflow", fake_mlflow)
    for load in (model_io.load_model_and_config, jax_model_io.load_model_and_config):
        with pytest.raises(ValueError, match="relative to the run's artifact"):
            load(
                tmp_path / "model_final.hdf5",
                mlflow_tracking_uri=str(tmp_path),
                mlflow_run_uuid="some-run",
            )
